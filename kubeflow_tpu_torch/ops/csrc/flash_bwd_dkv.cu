// K2: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_bwd_dkv_kernel (launched in
// _bwd). One block owns a 128-key tile of one KV head. It loops over the g
// query heads of that KV group and over their 64-row query tiles (from the
// diagonal on when causal), recomputes P^T = exp(scale * K Q^T - lse) and
// accumulates
//   dV += P^T dO,  dS^T = P^T * (V dO^T - delta),  dK += dS^T Q,
// then writes dK = scale * sum and dV in bf16, per KV head. The reference
// wrote per query head and summed the groups afterwards; summing inside the
// block needs no g-times buffer and no atomics.
//
// Bound on the H100: four tile products per (query, key) pair; at the bench
// shape ~60 GFLOP against ~177 MB, so the tensor cores bound it (~61 us at
// 989 TFLOP/s). Design against that (FlashAttention-3's dK/dV half):
// - Two warpgroups of 64 keys each, 256 threads, so that the launch gives
//   every thread up to 255 registers: dK, dV, S^T and dP^T take 192 f32 a
//   thread at D = 128 while products are in flight, and ptxas sizes the
//   wgmma pipeline by the launch's budget (a producer warpgroup beside them,
//   at 384 threads and 168 registers, serialised every wgmma and spilled).
//   K and V [128 x D] are loaded once by TMA; the (Q, dO) tiles of 64 query
//   rows stream through a four-stage ring of full/empty mbarriers, through
//   4-D tensor maps over [batch, seq, heads, head_dim] (zeros past seq).
//   Warp 0 refills the ring: at the top of each iteration it loads the stage
//   both warpgroups released last.
// - lse and delta rows cannot be a tensor map (their pitch, seq * 4 bytes, is
//   not a multiple of 16 for odd seq): the refilling warp copies them with
//   4-byte cp.async (zeros past seq), which arrive on the stage's full
//   barrier when they land (.noinc), beside lane 0's arrival with the TMA
//   bytes. Past seq, Q and dO are zero rows, so P^T dO and dS^T there are 0
//   whatever P^T is.
// - Per stage and warpgroup: S^T = K Q^T and dP^T = V dO^T with
//   wgmma m64n64k16, both operands K-major from shared memory; P^T and dS^T
//   in registers (scale * log2 e folded into one FFMA before exp2); then
//   dV += P^T dO and dK += dS^T Q with wgmma m64nDk16 and P^T, dS^T as the
//   register A operand, dO and Q read as MN-major B from the same tiles.
//   dK and dV stay in registers across the whole loop (128 f32 a thread at
//   D = 128). A tile whose every query lies before every key of the
//   warpgroup (causal) is skipped.
// - Epilogue: dK * scale and dV as bf16, staged in the warpgroup's own rows
//   of K's and V's buffers and stored by TMA, clipped at seq. Key tile 0,
//   which has the most query tiles when causal, is launched first.
#include "flash_common.cuh"

namespace {

constexpr int BK = 128;                // keys per block: two warpgroups x 64
constexpr int BQ = 64;                 // query rows per streamed tile
constexpr int STAGES = 4;
constexpr int THREADS = 256;           // two warpgroups
constexpr int KBOX = BK * 128;         // a K or V box: 128 rows x 64 bf16 columns, 16 KB
constexpr int QBOX = BQ * 128;         // a Q or dO box: 64 rows x 64 bf16 columns, 8 KB
constexpr int BAR_EPI = 1;             // named barriers 1, 2: each warpgroup's epilogue

struct Bars {
  uint64_t kv_full, full[STAGES], empty[STAGES];
  float lse[STAGES][BQ];    // lse of the stage's query rows (0 past seq)
  float delta[STAGES][BQ];  // delta of the stage's query rows (0 past seq)
};

template <int D>
constexpr int smem_bytes() {
  // K and V, then STAGES x (Q, dO)
  return 1024 + 2 * (D / 64) * KBOX + STAGES * 2 * (D / 64) * QBOX + (int)sizeof(Bars);
}

// The stage of iteration `it` (query head it / ntq, query tile it % ntq),
// loaded by one warp: lse and delta rows by 4-byte cp.async from every lane
// (rows lane, lane + 32), Q and dO by TMA from lane 0, all completing on the
// stage's full barrier. From the second round of the ring on, once both
// warpgroups have released the stage.
template <int D>
__device__ __forceinline__ void load_stage(Bars& bar, unsigned char* ring, const CUtensorMap* tq,
                                           const CUtensorMap* tdo, const FlashArgs& a, int it,
                                           int ntq, int qt_first, int kvi, int bi, int lane) {
  constexpr int QT = (D / 64) * QBOX;
  const int st = it % STAGES;
  if (it >= STAGES) mbar_wait(&bar.empty[st], ((it / STAGES) & 1) ^ 1);
  const int hh = kvi * (a.h / a.kv) + it / ntq, q0 = (qt_first + it % ntq) * BQ;
  const long long row = (long long)(bi * a.h + hh) * a.s;
  for (int r = lane; r < BQ; r += 32) {
    const bool ok = q0 + r < a.s;
    cp_async4(&bar.lse[st][r], a.lse + row + (ok ? q0 + r : 0), ok);
    cp_async4(&bar.delta[st][r], a.delta + row + (ok ? q0 + r : 0), ok);
  }
  cp_async_mbar_arrive(&bar.full[st]);
  if (lane == 0) {
    unsigned char* sq = ring + st * 2 * QT;
    mbar_arrive_expect_tx(&bar.full[st], 2 * QT);
    for (int i = 0; i < D / 64; ++i) {
      tma_load_4d(sq + i * QBOX, tq, &bar.full[st], 64 * i, hh, q0, bi);
      tma_load_4d(sq + QT + i * QBOX, tdo, &bar.full[st], 64 * i, hh, q0, bi);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const FlashArgs a, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tdk,
                         const __grid_constant__ CUtensorMap tdv) {
  constexpr int KT = (D / 64) * KBOX;  // K or V [128 x D]
  constexpr int QT = (D / 64) * QBOX;  // Q or dO [64 x D]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align1024(smem_raw);
  unsigned char* sv = sk + KT;
  unsigned char* ring = sv + KT;  // stage i: Q at ring + 2 i QT, dO after it
  Bars& bar = *reinterpret_cast<Bars*>(ring + STAGES * 2 * QT);

  const int tid = threadIdx.x, w = warpgroup_id(), t = tid % 128;
  const int s = a.s, g = a.h / a.kv;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y, bi = bkv / a.kv, kvi = bkv % a.kv;
  // (query head, query tile) pairs this block visits, flattened for the ring
  const int qt_first = a.causal ? k0 / BQ : 0;
  const int ntq = (s + BQ - 1) / BQ - qt_first;
  const int n_it = g * ntq;

  if (tid == 0) {
    mbar_init(&bar.kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.full[i], 33);  // the loading warp's 32 cp.async arrivals + lane 0's (TMA)
      mbar_init(&bar.empty[i], 2);  // one arrival per warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 32) {  // warp 0: K and V, then the first round of the ring
    if (tid == 0) {
      mbar_arrive_expect_tx(&bar.kv_full, 2 * KT);
      for (int i = 0; i < D / 64; ++i) {
        tma_load_4d(sk + i * KBOX, &tk, &bar.kv_full, 64 * i, kvi, k0, bi);
        tma_load_4d(sv + i * KBOX, &tv, &bar.kv_full, 64 * i, kvi, k0, bi);
      }
    }
    for (int it = 0; it < n_it && it < STAGES; ++it)
      load_stage<D>(bar, ring, &tq, &tdo, a, it, ntq, qt_first, kvi, bi, tid);
  }

  // two warpgroups, 64 keys each
  const int kw = k0 + 64 * w;  // this warpgroup's first key
  const int key0 = kw + 16 * (t >> 5) + ((t & 31) >> 2);  // keys key0 and key0 + 8
  const int c = 2 * (t & 3);
  const float sl2 = a.scale * FLASH_LOG2E;
  // this warpgroup's 64 keys of K and V: the K-major A of S^T and dP^T
  const uint64_t ak = sw128_desc(sk + w * 64 * 128, 16, 1024);
  const uint64_t av = sw128_desc(sv + w * 64 * 128, 16, 1024);

  float dk[D / 2], dv[D / 2], sc[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(&bar.kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_it; ++it) {
    // warp 0 refills the stage of iteration it - 1 (both warpgroups done
    // with it) three iterations ahead
    if (tid < 32 && it >= 1 && it - 1 + STAGES < n_it)
      load_stage<D>(bar, ring, &tq, &tdo, a, it - 1 + STAGES, ntq, qt_first, kvi, bi, tid);
    const int q0 = (qt_first + it % ntq) * BQ;
    mbar_wait(&bar.full[stage], phase);
    if (!a.causal || q0 + BQ > kw) {  // else every query lies before every key: P^T = 0
      const unsigned char* sq = ring + stage * 2 * QT;
      const unsigned char* sdo = sq + QT;
      const uint64_t bq = sw128_desc(sq, 16, 1024), bdo = sw128_desc(sdo, 16, 1024);
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(sc, ak + kstep(kk, KBOX), bq + kstep(kk, QBOX), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(dp, av + kstep(kk, KBOX), bdo + kstep(kk, QBOX), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // P^T and dS^T (scale applied at the end) for keys key0, key0 + 8 and
      // the 16 query columns 8 n + c (+ 1) of the tile
      const bool mask = a.causal && q0 < kw + 63;
      uint32_t pf[BQ / 16][4], df[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        float p[8], ds[8];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // n-tiles 2 kk and 2 kk + 1
          const int qc = 16 * kk + 8 * h2 + c;
          const float2 l2 = *reinterpret_cast<const float2*>(&bar.lse[stage][qc]);
          const float2 dl = *reinterpret_cast<const float2*>(&bar.delta[stage][qc]);
          const float lx = l2.x * FLASH_LOG2E, ly = l2.y * FLASH_LOG2E;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * h2 + e;
            float x = exp2_approx(fmaf(sc[8 * kk + i], sl2, -((e & 1) ? ly : lx)));
            if (mask && q0 + qc + (e & 1) < (e < 2 ? key0 : key0 + 8)) x = 0.f;
            p[i] = x;
            ds[i] = x * (dp[8 * kk + i] - ((e & 1) ? dl.y : dl.x));
          }
        }
        pf[kk][0] = pack_bf16(p[0], p[1]);
        pf[kk][1] = pack_bf16(p[2], p[3]);
        pf[kk][2] = pack_bf16(p[4], p[5]);
        pf[kk][3] = pack_bf16(p[6], p[7]);
        df[kk][0] = pack_bf16(ds[0], ds[1]);
        df[kk][1] = pack_bf16(ds[2], ds[3]);
        df[kk][2] = pack_bf16(ds[4], ds[5]);
        df[kk][3] = pack_bf16(ds[6], ds[7]);
      }

      // dO and Q [64 queries x D] as MN-major B: 64-column blocks one box
      // apart, a k16 step 16 query rows (2,048 bytes)
      const uint64_t mdo = sw128_desc(sdo, QBOX, 1024), mq = sw128_desc(sq, QBOX, 1024);
      fence_acc(dk);
      fence_acc(dv);
      fence_frags(pf);
      fence_frags(df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs_mn(dv, pf[kk], mdo + 128 * kk);
        wgmma_rs_mn(dk, df[kk], mq + 128 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
    }
    if (t == 0) mbar_arrive(&bar.empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] *= a.scale;
  // stage dK and dV in this warpgroup's rows of K's and V's buffers (only
  // its own products read them, and those are done); one thread stores
  // both by TMA
  unsigned char* own_k = sk + w * 64 * 128;
  unsigned char* own_v = sv + w * 64 * 128;
  acc_to_smem<D, KBOX>(dk, own_k, t);
  acc_to_smem<D, KBOX>(dv, own_v, t);
  fence_proxy_async();
  named_bar_sync(BAR_EPI + w, 128);
  if (t == 0 && kw < s) {
    for (int i = 0; i < D / 64; ++i) {
      tma_store_4d(&tdk, own_k + i * KBOX, 64 * i, kvi, kw, bi);
      tma_store_4d(&tdv, own_v + i * KBOX, 64 * i, kvi, kw, bi);
    }
    tma_store_commit();
    tma_store_wait_read();  // the stores have read shared memory: the block may exit
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tk, tv, tq, tdo, tdk, tdv;
  if (!flash_tensor_map(&tk, a.k, a.kv, a, BK) || !flash_tensor_map(&tv, a.v, a.kv, a, BK) ||
      !flash_tensor_map(&tq, a.q, a.h, a, BQ) || !flash_tensor_map(&tdo, a.dout, a.h, a, BQ) ||
      !flash_tensor_map(&tdk, a.dk, a.kv, a, 64) || !flash_tensor_map(&tdv, a.dv, a.kv, a, 64))
    return cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES];  // one record per instantiation
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D>),
                               smem_bytes<D>(), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BK - 1) / BK, a.b * a.kv);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(a, tk, tv, tq, tdo, tdk, tdv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dkv_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
