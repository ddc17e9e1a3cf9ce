// K1: causal or non-causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd). Computes O = softmax(scale * Q K^T) V with an online softmax in f32
// and writes lse = m + log(l) per query row as [batch * heads, seq] (the TPU
// kernel's trailing 8-lane axis is a TPU layout artifact and is dropped).
//
// Bound on the H100: at the bench shape (b=14, s=1024, h=kv=8, d=128, causal)
// the function moves ~118 MB and does ~30 GFLOP, so memory bounds it (~35 us
// at 3.35 TB/s) with the tensor cores close behind (~30 us at 989 TFLOP/s),
// and the softmax's ~66 M exponentials take ~15-18 us of the SFUs unless they
// run under the products. Design against that (FlashAttention-3's forward):
// - One block owns a 128-row query tile of one (batch, head): two warpgroups
//   of 64 query rows each, 256 threads, so that the launch gives every thread
//   up to 255 registers. The products in flight need 160 a thread at D = 128
//   (O, S and P), and ptxas sizes the wgmma pipeline by the launch's budget:
//   with a producer warpgroup beside them (384 threads, 168 registers; the
//   consumers' setmaxnreg grant does not count) it serialised every wgmma
//   and spilled. So there is no producer warp: thread 0 starts the first
//   loads, and the warpgroup that goes second in each turn refills the stage
//   the turn has just freed.
// - Q [128 x D] is loaded once; K and V tiles of 128 keys stream through a
//   ring of full/empty mbarriers, K and V on barriers of their own, so a
//   stage's K is released as soon as the scores are done. Loads go through a
//   4-D tensor map over [batch, seq, heads, head_dim], so a ragged last tile
//   reads zeros past seq and never crosses into the next batch row.
// - S = Q K^T is wgmma m64n128k16 with both operands K-major in shared memory,
//   straight from the 128-byte-swizzled TMA tiles. The softmax runs on the
//   accumulators in registers (scale * log2 e folded into one FFMA before
//   exp2; lse converted back to natural log). P goes back in as the register
//   A operand of O += P V, wgmma m64nDk16 with V an MN-major B.
// - The two warpgroups take turns on two named barriers: each issues its
//   products of one turn (the scores of tile j and P V of tile j - 1) in one
//   go and hands the turn over, so one warpgroup's softmax runs while the
//   other's products run on the tensor cores.
// - Causal: the key loop stops at the diagonal tile; only the diagonal tile
//   and a ragged last tile are masked.
// - Epilogue: O is normalised, staged as bf16 in the warpgroup's own rows of
//   Q's buffer (free by then) and stored by TMA, clipped at seq; lse is a
//   plain store. Query tiles are launched longest first.
//
// The TPU grid carried (m, l, acc) in scratch across a sequential k axis; here
// the k loop lives inside one thread block and the state lives in registers.
#include "flash_common.cuh"

namespace {

constexpr int BR = 128;                // query rows per block: two warpgroups x 64
constexpr int BC = 128;                // keys per tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;           // two warpgroups
constexpr int BOX = 128 * 128;         // one box: 128 rows x 64 bf16 columns, 16 KB
constexpr int BAR_TURN = 1;            // named barriers 1, 2: the warpgroups' turns
constexpr int BAR_EPI = 3;             // named barriers 3, 4: each warpgroup's epilogue

struct Bars {
  uint64_t q_full, k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / 64) * BOX;  // 128 rows x D
}

template <int D>
constexpr int smem_bytes() {
  return 1024 + (1 + 2 * STAGES) * tile_bytes<D>() + (int)sizeof(Bars);
}

// S = Q K^T for this warpgroup's 64 query rows (descriptor dq) and the key
// tile at sk: m64n128k16, both operands K-major.
template <int D>
__device__ __forceinline__ void scores(float (&sc)[BC / 2], uint64_t dq, const unsigned char* sk) {
  const uint64_t dk = sw128_desc(sk, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16<0, 0>(sc, dq + kstep(kk, BOX), dk + kstep(kk, BOX), kk > 0);
}

// O += P V for the value tile at sv: V [128 keys x D] is an MN-major B,
// 64-column blocks one box apart, a k16 step 16 key rows (2,048 bytes).
template <int D>
__device__ __forceinline__ void p_times_v(float (&o)[D / 2], const uint32_t (&pf)[BC / 16][4],
                                          const unsigned char* sv) {
  const uint64_t dv = sw128_desc(sv, BOX, 1024);
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) wgmma_rs_mn(o, pf[kk], dv + 128 * kk);
}

// Running state of one thread's two query rows (r, r + 8): the max of
// scale * log2 e * S and the thread's partial row sums.
struct RowState {
  float m0 = FLASH_NEG_INF, m1 = FLASH_NEG_INF, l0 = 0.f, l1 = 0.f;
};

// The online softmax of one score tile (keys k0 ..): masks it where asked,
// updates the running max and sums, rescales O, and packs P as bf16 into the
// register A operand of P V.
template <int D>
__device__ __forceinline__ void online_softmax(float (&sc)[BC / 2], uint32_t (&pf)[BC / 16][4],
                                               float (&o)[D / 2], RowState& st, bool mask,
                                               bool causal, int k0, int s, int r0, int c,
                                               float sl2) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + c + (e & 1), row = e < 2 ? r0 : r0 + 8;
        if (col >= s || (causal && col > row)) sc[4 * n + e] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  // the reference scales q in f32 before an f32 product; scaling the f32
  // accumulator is that arithmetic without rounding q * scale to bf16
  const float mn0 = fmaxf(st.m0, quad_max(mx0) * sl2), mn1 = fmaxf(st.m1, quad_max(mx1) * sl2);
  const float c0 = exp2_approx(st.m0 - mn0), c1 = exp2_approx(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = exp2_approx(fmaf(sc[8 * kk + e], sl2, -((e & 2) ? mn1 : mn0)));
    ls0 += p[0] + p[1] + p[4] + p[5];
    ls1 += p[2] + p[3] + p[6] + p[7];
    pf[kk][0] = pack_bf16(p[0], p[1]);
    pf[kk][1] = pack_bf16(p[2], p[3]);
    pf[kk][2] = pack_bf16(p[4], p[5]);
    pf[kk][3] = pack_bf16(p[6], p[7]);
  }
  // l stays a per-thread partial sum; the quad reduces it once at the end
  st.l0 = st.l0 * c0 + ls0;
  st.l1 = st.l1 * c1 + ls1;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= c0;
    o[4 * i + 1] *= c0;
    o[4 * i + 2] *= c1;
    o[4 * i + 3] *= c1;
  }
}

// Key tile T (K and V, each on its own full barrier) into its stage: from the
// second round of the ring on, once both warpgroups have released the stage's
// last tile.
template <int D>
__device__ __forceinline__ void load_kv(Bars& bar, unsigned char* sk, unsigned char* sv,
                                        const CUtensorMap* tk, const CUtensorMap* tv, int T, int kvi,
                                        int bi) {
  constexpr int TILE = tile_bytes<D>();
  const int st = T % STAGES;
  const uint32_t parity = ((T / STAGES) & 1) ^ 1;
  if (T >= STAGES) mbar_wait(&bar.k_empty[st], parity);
  mbar_arrive_expect_tx(&bar.k_full[st], TILE);
  for (int i = 0; i < D / 64; ++i)
    tma_load_4d(sk + st * TILE + i * BOX, tk, &bar.k_full[st], 64 * i, kvi, T * BC, bi);
  if (T >= STAGES) mbar_wait(&bar.v_empty[st], parity);
  mbar_arrive_expect_tx(&bar.v_full[st], TILE);
  for (int i = 0; i < D / 64; ++i)
    tma_load_4d(sv + st * TILE + i * BOX, tv, &bar.v_full[st], 64 * i, kvi, T * BC, bi);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const FlashArgs a, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sk = sq + TILE;
  unsigned char* sv = sk + STAGES * TILE;
  Bars& bar = *reinterpret_cast<Bars*>(sv + STAGES * TILE);

  const int tid = threadIdx.x, w = warpgroup_id(), t = tid % 128;
  const int s = a.s;
  const int qt = (s + BR - 1) / BR - 1 - blockIdx.x, q0 = qt * BR;  // longest tiles first
  const int bh = blockIdx.y, bi = bh / a.h, hi = bh % a.h, kvi = hi / (a.h / a.kv);
  const int nk = a.causal ? qt + 1 : (s + BC - 1) / BC;  // causal: up to the diagonal tile

  if (tid == 0) {
    mbar_init(&bar.q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.k_full[i], 1);   // the loading thread's arrival + the TMA bytes
      mbar_init(&bar.v_full[i], 1);
      mbar_init(&bar.k_empty[i], 2);  // one arrival per warpgroup
      mbar_init(&bar.v_empty[i], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid == 0) {
    mbar_arrive_expect_tx(&bar.q_full, TILE);
    for (int i = 0; i < D / 64; ++i) tma_load_4d(sq + i * BOX, &tq, &bar.q_full, 64 * i, hi, q0, bi);
    for (int T = 0; T < nk && T < STAGES; ++T) load_kv<D>(bar, sk, sv, &tk, &tv, T, kvi, bi);
  }

  // two warpgroups, 64 query rows each
  const uint64_t dq = sw128_desc(sq + w * 64 * 128, 16, 1024);  // this warpgroup's Q rows
  const float sl2 = a.scale * FLASH_LOG2E;
  const int r0 = q0 + 64 * w + 16 * (t >> 5) + ((t & 31) >> 2);  // rows r0 and r0 + 8
  const int c = 2 * (t & 3);

  float o[D / 2], sc[BC / 2];
  uint32_t pf[BC / 16][4];  // P of the last tile: the A operand of P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) sc[i] = 0.f;
  RowState rs;

  // Turn j of a warpgroup issues the scores of tile j (j < nk) and P V of
  // tile j - 1 (j > 0), then hands the turn to the other warpgroup; the
  // first and last turns are peeled, so no product is issued under a
  // condition.
  if (w == 1) named_bar_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  mbar_wait(&bar.q_full, 0);
  int st = 0;  // stage and phase of tile j
  uint32_t ph = 0;
  mbar_wait(&bar.k_full[0], 0);
  named_bar_sync(BAR_TURN + w, 256);
  fence_acc(sc);
  wgmma_fence();
  scores<D>(sc, dq, sk);
  wgmma_commit();
  named_bar_arrive(BAR_TURN + 1 - w, 256);
  wgmma_wait<0>();
  fence_acc(sc);
  if (t == 0) mbar_arrive(&bar.k_empty[0]);
  online_softmax<D>(sc, pf, o, rs, (a.causal && nk == 1) || BC > s, a.causal, 0, s, r0, c, sl2);
  for (int j = 1; j < nk; ++j) {
    const int pst = st;
    const uint32_t pph = ph;
    if (++st == STAGES) { st = 0; ph ^= 1; }
    mbar_wait(&bar.k_full[st], ph);
    mbar_wait(&bar.v_full[pst], pph);
    named_bar_sync(BAR_TURN + w, 256);
    fence_acc(o);
    fence_acc(sc);
    fence_frags(pf);
    wgmma_fence();
    scores<D>(sc, dq, sk + st * TILE);
    p_times_v<D>(o, pf, sv + pst * TILE);
    wgmma_commit();
    named_bar_arrive(BAR_TURN + 1 - w, 256);
    wgmma_wait<0>();
    fence_acc(o);
    fence_acc(sc);
    if (t == 0) {
      mbar_arrive(&bar.k_empty[st]);
      mbar_arrive(&bar.v_empty[pst]);
      // warpgroup 1 goes second: by now both have released tile j - 1
      if (w == 1 && j - 1 + STAGES < nk) load_kv<D>(bar, sk, sv, &tk, &tv, j - 1 + STAGES, kvi, bi);
    }
    const int k0 = j * BC;
    online_softmax<D>(sc, pf, o, rs, (a.causal && j == nk - 1) || k0 + BC > s, a.causal, k0, s,
                      r0, c, sl2);
  }
  mbar_wait(&bar.v_full[st], ph);
  named_bar_sync(BAR_TURN + w, 256);
  fence_acc(o);
  fence_frags(pf);
  wgmma_fence();
  p_times_v<D>(o, pf, sv + st * TILE);
  wgmma_commit();
  if (w == 0) named_bar_arrive(BAR_TURN + 1, 256);  // warpgroup 1's last turn has no successor
  wgmma_wait<0>();
  fence_acc(o);
  if (t == 0) mbar_arrive(&bar.v_empty[st]);

  const float l0 = fmaxf(quad_sum(rs.l0), 1e-30f), l1 = fmaxf(quad_sum(rs.l1), 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= inv0;
    o[4 * i + 1] *= inv0;
    o[4 * i + 2] *= inv1;
    o[4 * i + 3] *= inv1;
  }
  if ((t & 3) == 0) {
    float* lse = a.lse + (long long)bh * s;
    if (r0 < s) lse[r0] = rs.m0 * FLASH_LN2 + logf(l0);
    if (r0 + 8 < s) lse[r0 + 8] = rs.m1 * FLASH_LN2 + logf(l1);
  }
  // stage O in this warpgroup's rows of Q's buffer (only its own products
  // read them, and those are done); one thread stores it by TMA
  unsigned char* own = sq + w * 64 * 128;
  acc_to_smem<D, BOX>(o, own, t);
  fence_proxy_async();
  named_bar_sync(BAR_EPI + w, 128);
  if (t == 0 && q0 + 64 * w < s) {
    for (int i = 0; i < D / 64; ++i) tma_store_4d(&to, own + i * BOX, 64 * i, hi, q0 + 64 * w, bi);
    tma_store_commit();
    tma_store_wait_read();  // the stores have read shared memory: the block may exit
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!flash_tensor_map(&tq, a.q, a.h, a, BR) || !flash_tensor_map(&tk, a.k, a.kv, a, BC) ||
      !flash_tensor_map(&tv, a.v, a.kv, a, BC) || !flash_tensor_map(&to, a.o, a.h, a, 64))
    return cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES];  // one record per instantiation
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_fwd_kernel<D>), smem_bytes<D>(), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BR - 1) / BR, a.b * a.h);
  flash_fwd_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(a, tq, tk, tv, to);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
