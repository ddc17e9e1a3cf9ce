// K3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched in
// _bwd). One block owns a 128-row query tile of one (batch, query head). It
// loops over the key tiles (up to the diagonal when causal), recomputes
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta),
// accumulates dQ += dS K, and writes dQ = scale * sum in bf16. delta =
// rowsum(dO * O) - dlse comes from the caller, as in the reference.
//
// Bound on the H100: three tile products per (query, key) pair; at the bench
// shape (b=14, s=1024, h=kv=8, d=128, causal) ~45 GFLOP against ~148 MB, so
// the tensor cores bound it (~46 us at 989 TFLOP/s) with memory close behind
// (~44 us at 3.35 TB/s). Design against that (K2's, flash_bwd_dkv.cu, with
// the roles of the operands swapped):
// - Two warpgroups of 64 query rows each, 256 threads, so that the launch
//   gives every thread up to 255 registers: dQ, S and dP take 192 f32 a
//   thread at D = 128 while products are in flight, and ptxas sizes the
//   wgmma pipeline by the launch's budget (with a producer warpgroup beside
//   them it serialised every wgmma). Q and dO [128 x D] are loaded once by
//   TMA; the (K, V) tiles of 128 keys of KV head hi / g stream through a
//   two-stage ring of full/empty mbarriers (192 KB of shared memory with Q
//   and dO at D = 128), through 4-D tensor maps over [batch, seq, heads,
//   head_dim] (zeros past seq). Thread 0 refills the ring: at the top of
//   each iteration it loads the next tile into the stage both warpgroups
//   released last. 128-key tiles in two stages measured 9% faster than
//   64-key tiles in four (PERF.md).
// - A block's query rows are fixed: each thread reads the lse and delta of
//   its two rows once, before the key loop (0 past seq).
// - Per stage and warpgroup: S = Q K^T and dP = dO V^T with wgmma
//   m64n128k16, both operands K-major from shared memory, committed as two
//   groups, so that P is computed in place of S (scale * log2 e folded into
//   one FFMA before exp2) while the dP product runs; dS in registers; then
//   dQ += dS K with wgmma m64nDk16, dS as the register A operand and K read
//   as an MN-major B from the same stage. dQ stays in registers across the
//   whole loop; with no atomics a second launch gives the same bits.
// - Causal: the key loop stops at the key tile on the query tile's
//   diagonal, and only that tile is masked. A warpgroup with no row before
//   seq skips every tile, still releasing each stage.
// - Ragged keys: the stage that holds key seq - 1 masks the keys past it.
//   A zero key row would give P = exp(-lse), which overflows once lse is
//   below about -88, and inf * 0 in dS K is NaN. Query rows past seq need no
//   mask: Q and dO are zero there and lse and delta read 0, so dS = 0.
// - Epilogue: dQ * scale as bf16, staged in the warpgroup's own rows of Q's
//   buffer (free after its last S product) and stored by TMA, clipped at
//   seq. The last query tile, which has the most key tiles when causal, is
//   launched first.
#include "flash_common.cuh"

namespace {

constexpr int BR = 128;          // query rows per block: two warpgroups x 64
constexpr int BC = 128;          // keys per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 256;     // two warpgroups
constexpr int QBOX = BR * 128;   // a Q or dO box: 128 rows x 64 bf16 columns, 16 KB
constexpr int KBOX = BC * 128;   // a K or V box: 128 rows x 64 bf16 columns, 16 KB
constexpr int BAR_EPI = 1;       // named barriers 1, 2: each warpgroup's epilogue

struct Bars {
  uint64_t q_full, full[STAGES], empty[STAGES];
};

template <int D>
constexpr int smem_bytes() {
  // Q and dO, then STAGES x (K, V)
  return 1024 + 2 * (D / 64) * QBOX + STAGES * 2 * (D / 64) * KBOX + (int)sizeof(Bars);
}

// Key tile `it` (K and V) into its stage by TMA, completing on the stage's
// full barrier: from the second round of the ring on, once both warpgroups
// have released the stage.
template <int D>
__device__ __forceinline__ void load_stage(Bars& bar, unsigned char* ring, const CUtensorMap* tk,
                                           const CUtensorMap* tv, int it, int kvi, int bi) {
  constexpr int KT = (D / 64) * KBOX;
  const int st = it % STAGES;
  if (it >= STAGES) mbar_wait(&bar.empty[st], ((it / STAGES) & 1) ^ 1);
  unsigned char* sk = ring + st * 2 * KT;
  mbar_arrive_expect_tx(&bar.full[st], 2 * KT);
  for (int i = 0; i < D / 64; ++i) {
    tma_load_4d(sk + i * KBOX, tk, &bar.full[st], 64 * i, kvi, it * BC, bi);
    tma_load_4d(sk + KT + i * KBOX, tv, &bar.full[st], 64 * i, kvi, it * BC, bi);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const FlashArgs a, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdq) {
  constexpr int QT = (D / 64) * QBOX;  // Q or dO [128 x D]
  constexpr int KT = (D / 64) * KBOX;  // K or V [128 x D]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sdo = sq + QT;
  unsigned char* ring = sdo + QT;  // stage i: K at ring + 2 i KT, V after it
  Bars& bar = *reinterpret_cast<Bars*>(ring + STAGES * 2 * KT);

  const int tid = threadIdx.x, w = warpgroup_id(), t = tid % 128;
  const int s = a.s;
  const int q0 = ((s + BR - 1) / BR - 1 - blockIdx.x) * BR;  // longest tiles first
  const int bh = blockIdx.y, bi = bh / a.h, hi = bh % a.h, kvi = hi / (a.h / a.kv);
  // key tiles up to the one holding the last key the tile's last row sees
  const int n_it = ((a.causal ? min(q0 + BR, s) : s) - 1) / BC + 1;

  if (tid == 0) {
    mbar_init(&bar.q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.full[i], 1);   // the loading thread's arrival + the TMA bytes
      mbar_init(&bar.empty[i], 2);  // one arrival per warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid == 0) {  // Q and dO, then the first round of the ring
    mbar_arrive_expect_tx(&bar.q_full, 2 * QT);
    for (int i = 0; i < D / 64; ++i) {
      tma_load_4d(sq + i * QBOX, &tq, &bar.q_full, 64 * i, hi, q0, bi);
      tma_load_4d(sdo + i * QBOX, &tdo, &bar.q_full, 64 * i, hi, q0, bi);
    }
    for (int it = 0; it < n_it && it < STAGES; ++it)
      load_stage<D>(bar, ring, &tk, &tv, it, kvi, bi);
  }

  // two warpgroups, 64 query rows each
  const int qw = q0 + 64 * w;                           // this warpgroup's first row
  const int r0 = qw + 16 * (t >> 5) + ((t & 31) >> 2);  // rows r0 and r0 + 8
  const int c = 2 * (t & 3);
  const float sl2 = a.scale * FLASH_LOG2E;
  const float* lse = a.lse + (long long)bh * s;
  const float* delta = a.delta + (long long)bh * s;
  const float l0 = r0 < s ? lse[r0] * FLASH_LOG2E : 0.f;
  const float l1 = r0 + 8 < s ? lse[r0 + 8] * FLASH_LOG2E : 0.f;
  const float d0 = r0 < s ? delta[r0] : 0.f, d1 = r0 + 8 < s ? delta[r0 + 8] : 0.f;
  // this warpgroup's 64 rows of Q and dO: the K-major A of S and dP
  const uint64_t aq = sw128_desc(sq + w * 64 * 128, 16, 1024);
  const uint64_t ado = sw128_desc(sdo + w * 64 * 128, 16, 1024);

  float dq[D / 2], sc[BC / 2], dp[BC / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(&bar.q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_it; ++it) {
    // thread 0 refills the stage of iteration it - 1 (both warpgroups done
    // with it) with the tile of the next iteration
    if (tid == 0 && it >= 1 && it - 1 + STAGES < n_it)
      load_stage<D>(bar, ring, &tk, &tv, it - 1 + STAGES, kvi, bi);
    const int k0 = it * BC;
    mbar_wait(&bar.full[stage], phase);
    if (qw < s) {  // else this warpgroup has no row before seq
      const unsigned char* sk = ring + stage * 2 * KT;
      const unsigned char* sv = sk + KT;
      const uint64_t bk = sw128_desc(sk, 16, 1024), bv = sw128_desc(sv, 16, 1024);
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16<0, 0>(sc, aq + kstep(kk, QBOX), bk + kstep(kk, KBOX), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16<0, 0>(dp, ado + kstep(kk, QBOX), bv + kstep(kk, KBOX), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(sc);

      // P in place of S while the dP product runs, for rows r0, r0 + 8 and
      // the 16 keys k0 + 16 kk + 8 h2 + c (+ 1) of k16 step kk
      const bool mask = (a.causal && k0 + BC - 1 > qw) || k0 + BC > s;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // n-tiles 2 kk and 2 kk + 1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * h2 + e;
            float x = exp2_approx(fmaf(sc[8 * kk + i], sl2, -(e < 2 ? l0 : l1)));
            if (mask) {
              const int key = k0 + 16 * kk + 8 * h2 + c + (e & 1);
              if (key >= s || (a.causal && key > (e < 2 ? r0 : r0 + 8))) x = 0.f;
            }
            sc[8 * kk + i] = x;
          }
        }
      }
      wgmma_wait<0>();
      fence_acc(dp);
      // dS (scale applied at the end), packed as the bf16 A operand of dS K
      uint32_t df[BC / 16][4];
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)  // rows r0 (i % 4 < 2) and r0 + 8
          ds[i] = sc[8 * kk + i] * (dp[8 * kk + i] - (i % 4 < 2 ? d0 : d1));
        df[kk][0] = pack_bf16(ds[0], ds[1]);
        df[kk][1] = pack_bf16(ds[2], ds[3]);
        df[kk][2] = pack_bf16(ds[4], ds[5]);
        df[kk][3] = pack_bf16(ds[6], ds[7]);
      }

      // K [128 keys x D] as MN-major B: 64-column blocks one box apart, a
      // k16 step 16 key rows (2,048 bytes)
      const uint64_t mk = sw128_desc(sk, KBOX, 1024);
      fence_acc(dq);
      fence_frags(df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) wgmma_rs_mn(dq, df[kk], mk + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    if (t == 0) mbar_arrive(&bar.empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] *= a.scale;
  // stage dQ in this warpgroup's rows of Q's buffer (only its own products
  // read them, and those are done); one thread stores it by TMA
  unsigned char* own = sq + w * 64 * 128;
  acc_to_smem<D, QBOX>(dq, own, t);
  fence_proxy_async();
  named_bar_sync(BAR_EPI + w, 128);
  if (t == 0 && qw < s) {
    for (int i = 0; i < D / 64; ++i) tma_store_4d(&tdq, own + i * QBOX, 64 * i, hi, qw, bi);
    tma_store_commit();
    tma_store_wait_read();  // the stores have read shared memory: the block may exit
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!flash_tensor_map(&tq, a.q, a.h, a, BR) || !flash_tensor_map(&tdo, a.dout, a.h, a, BR) ||
      !flash_tensor_map(&tk, a.k, a.kv, a, BC) || !flash_tensor_map(&tv, a.v, a.kv, a, BC) ||
      !flash_tensor_map(&tdq, a.dq, a.h, a, 64))
    return cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES];  // one record per instantiation
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>),
                               smem_bytes<D>(), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BR - 1) / BR, a.b * a.h);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(a, tq, tdo, tk, tv, tdq);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
