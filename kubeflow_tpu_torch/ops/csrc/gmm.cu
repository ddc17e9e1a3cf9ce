// K4a: grouped matrix multiply over expert-sorted rows, for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/grouped_matmul.py::_gmm (MegaBlox ``gmm``, also
// the dx product of _vjp_bwd):
//   out[i] = x[i] @ w[e]      for offsets[e] <= i < offsets[e + 1],
// with x [B, K] and w [E, K, N] (or w [E, N, K] read transposed, so the
// backward's dx = g @ w[e]^T needs no transposed copy of the weights). Rows
// of no group (before offsets[0] or at/after offsets[E]) are written as zeros.
//
// Bound on the H100: at the MoE bench shape (B = 28,644 rows, K = 1024,
// N = 2816, E = 8) one launch is 165 GFLOP against 0.27 GB, so the tensor
// cores bound it (0.167 ms at 989 TFLOP/s). Design against that:
// - Tensor cores through wgmma: each block computes 128 x 256 output tiles,
//   two consumer warpgroups of 64 rows each running m64n256k16 products from
//   shared memory (128 f32 accumulators a thread), 64-deep K slices.
// - Loads through TMA: one producer thread keeps a three-stage ring of
//   48 KB slices (16 KB of x, 32 KB of w[e], 128-byte swizzle) in flight,
//   tracked by full/empty mbarriers; the producer warpgroup gives its
//   registers to the consumers (setmaxnreg). w is one 3-D tensor map, the
//   expert a coordinate. x is K-major (A); w [K, N] is an MN-major B (the
//   transpose bit set), w [N, K] with trans_w a K-major B. Columns of K or N
//   past the tensor load as zeros.
// - A persistent grid: min(#SMs, most units) blocks, each reading the offsets
//   once and walking the units u = blockIdx.x, + gridDim.x, ... with a static
//   stride (no atomics, so the result is bitwise reproducible). A unit is a
//   (segment, 128-row tile, 256-column tile): the E + 2 segments are the head
//   rows [0, offsets[0]), the E groups and the tail rows [offsets[E], B). Row
//   tiles are outer and column tiles inner, so the blocks in flight share one
//   group's w[e] in L2. While the consumers finish a unit, the producer
//   already loads the next one's slices.
// - The epilogue: a warpgroup whose 64 rows all lie in the unit's group
//   stages its tile in shared memory (swizzled, conflict-free) and one thread
//   stores it by TMA, which runs on while the next unit's products start. A
//   tile that straddles a group boundary was loaded whole and computed with
//   this group's weights (each output row depends only on its own x row); it
//   stores only the group's rows, with masked st.global, since a whole-tile
//   store would overwrite the neighbouring group's rows, which another unit
//   writes. Head and tail units store zeros.
#include "hopper_gemm.cuh"

// Must match kubeflow_tpu_torch/ops/grouped_matmul.py::_GmmArgs.
struct GmmArgs {
  const bf16* x;        // [B, K], row stride ldx
  long long ldx;
  const bf16* w;        // [E, K, N], or [E, N, K] when trans_w
  long long swe, swr;   // expert stride, row stride
  bf16* out;            // [B, N], row stride ldo
  long long ldo;
  const int* offsets;   // [E + 1], int32 on the device
  int b, k, n, e, trans_w;
};

#define GMM_MAX_EXPERTS 256  // grouped_matmul.py::MAX_EXPERTS

namespace {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int THREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;     // x slice: 128 rows x 128 bytes
constexpr int B_BOX = 64 * BK * 2;       // one 64 x 64 box of w
constexpr int B_BYTES = BN * BK * 2;     // w slice: four boxes, or one [256 n][64 k] box
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BYTES = BM * BN * 2;   // the output tile, staged for the TMA store
constexpr int NSEG_MAX = GMM_MAX_EXPERTS + 2;

struct Sched {
  uint64_t full[STAGES], empty[STAGES];
  int bnd[NSEG_MAX + 1];  // segment boundaries: 0, offsets clamped monotone into [0, B], B
  int cum[NSEG_MAX + 1];  // row tiles of the segments before each one
};
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + (int)sizeof(Sched);

struct Unit {
  int seg, r0, lo, hi, n0;  // segment, tile's first row, its rows [lo, hi), first column
};

__device__ __forceinline__ Unit unit_at(const Sched& s, int u, int ntn, int nseg) {
  const int slot = u / ntn;
  int a = 0, b = nseg - 1;  // the last segment whose tiles start at or before slot
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (s.cum[m] <= slot) a = m; else b = m - 1;
  }
  Unit t;
  t.seg = a;
  t.r0 = (s.bnd[a] / BM + slot - s.cum[a]) * BM;
  t.lo = max(s.bnd[a], t.r0);
  t.hi = min(s.bnd[a + 1], t.r0 + BM);
  t.n0 = (u % ntn) * BN;
  return t;
}

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_kernel(const GmmArgs a, const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap to) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* staged = ring + STAGES * STAGE_BYTES;
  Sched& s = *reinterpret_cast<Sched*>(staged + OUT_BYTES);
  const int tid = threadIdx.x, nseg = a.e + 2;

  for (int i = tid; i <= a.e; i += THREADS) s.bnd[i + 1] = a.offsets[i];
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);   // the producer's arrival + the TMA bytes
      mbar_init(&s.empty[i], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    s.bnd[0] = 0;
    for (int i = 1; i <= a.e + 1; ++i) s.bnd[i] = min(max(s.bnd[i], s.bnd[i - 1]), a.b);
    s.bnd[nseg] = a.b;
    s.cum[0] = 0;
    for (int j = 0; j < nseg; ++j) {
      const int s0 = s.bnd[j], s1 = s.bnd[j + 1];
      s.cum[j + 1] = s.cum[j] + (s1 > s0 ? (s1 - 1) / BM - s0 / BM + 1 : 0);
    }
  }
  __syncthreads();
  const int ntn = (a.n + BN - 1) / BN;
  const int units = s.cum[nseg] * ntn;

  if (tid < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_at(s, u, ntn, nseg);
        if (t.seg == 0 || t.seg == nseg - 1) continue;  // zeros: no loads
        const int e = t.seg - 1;
        int boxes = 1;  // w boxes inside N (trans_w: one box, partly inside)
        if (!TRANS) boxes = min(4, (a.n - t.n0 + 63) / 64);
        for (int k0 = 0; k0 < a.k; k0 += BK) {
          mbar_wait(&s.empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(&s.full[stage], A_BYTES + (TRANS ? B_BYTES : boxes * B_BOX));
          tma_load_2d(st, &tx, &s.full[stage], k0, t.r0);
          if (TRANS) {
            tma_load_3d(st + A_BYTES, &tw, &s.full[stage], k0, t.n0, e);
          } else {
            for (int i = 0; i < boxes; ++i)
              tma_load_3d(st + A_BYTES + i * B_BOX, &tw, &s.full[stage], t.n0 + 64 * i, k0, e);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the tile each
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, t = tid % 128;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit q = unit_at(s, u, ntn, nseg);
      if (q.seg == 0 || q.seg == nseg - 1) {  // rows of no group
        store_zeros(a.out, a.ldo, q.lo, q.hi, q.n0, min(q.n0 + BN, a.n), tid - 128, 256);
        continue;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int k0 = 0; k0 < a.k; k0 += BK) {
        mbar_wait(&s.full[stage], phase);
        const unsigned char* st = ring + stage * STAGE_BYTES;
        const uint64_t da = sw128_desc(st + cw * 64 * 128, 16, 1024);
        const uint64_t db = sw128_desc(st + A_BYTES, TRANS ? 16 : B_BOX, 1024);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // k16 steps: 32 bytes (K-major), 16 rows (MN-major)
          wgmma_m64n256k16<0, TRANS ? 0 : 1>(acc, da + 2 * kk, db + (TRANS ? 2 : 128) * kk, 1);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous slice's products are done: release its stage
        if (prev >= 0 && t == 0) mbar_arrive(&s.empty[prev]);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(&s.empty[prev]);
      const int row0 = q.r0 + 64 * cw;  // this warpgroup's 64 rows
      if (row0 >= a.b) continue;
      if (q.lo <= row0 && min(row0 + 64, a.b) <= q.hi) {
        // every row is the group's: stage the tile, one thread stores it by TMA
        unsigned char* own = staged + cw * (OUT_BYTES / 2);
        if (t == 0) tma_store_wait_read();  // the last unit's store has read `own`
        named_bar_sync(1 + cw, 128);
        acc_to_smem<BN>(acc, own, t);
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
        if (t == 0) {
          for (int i = 0; i < BN / 64 && q.n0 + 64 * i < a.n; ++i)
            tma_store_2d(&to, own + i * B_BOX, q.n0 + 64 * i, row0);
          tma_store_commit();
        }
      } else {  // rows of another segment lie in the tile: masked stores
        store_acc<BN>(acc, a.out, a.ldo, row0, q.lo, q.hi, q.n0, a.n, t);
      }
    }
    if (t == 0) tma_store_wait();  // before the block's shared memory goes away
  }
}

template <bool TRANS>
cudaError_t launch(const GmmArgs& a, cudaStream_t stream) {
  CUtensorMap tx, tw, to;
  const cuuint64_t x_dims[2] = {(cuuint64_t)a.k, (cuuint64_t)a.b};
  const cuuint64_t x_strides[1] = {(cuuint64_t)a.ldx * 2};
  const cuuint32_t x_box[2] = {BK, BM};
  // w[e] as [K, N] (boxes of 64 k x 64 n) or, with trans_w, [N, K] (256 n x 64 k)
  const cuuint64_t w_dims[3] = {(cuuint64_t)(TRANS ? a.k : a.n), (cuuint64_t)(TRANS ? a.n : a.k),
                                (cuuint64_t)a.e};
  const cuuint64_t w_strides[2] = {(cuuint64_t)a.swr * 2, (cuuint64_t)a.swe * 2};
  const cuuint32_t w_box[3] = {64, TRANS ? (cuuint32_t)BN : (cuuint32_t)BK, 1};
  const cuuint64_t o_dims[2] = {(cuuint64_t)a.n, (cuuint64_t)a.b};
  const cuuint64_t o_strides[1] = {(cuuint64_t)a.ldo * 2};
  const cuuint32_t o_box[2] = {64, 64};
  if (!make_tensor_map(&tx, a.x, 2, x_dims, x_strides, x_box) ||
      !make_tensor_map(&tw, a.w, 3, w_dims, w_strides, w_box) ||
      !make_tensor_map(&to, a.out, 2, o_dims, o_strides, o_box))
    return cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES];  // one record per instantiation
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(gmm_kernel<TRANS>), SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return err;
  // the most units the offsets can make: every row tile, plus one split per boundary
  const long long most =
      ((long long)(a.b + BM - 1) / BM + a.e + 1) * ((a.n + BN - 1) / BN);
  if (most > 0x7fffffffLL) return cudaErrorInvalidValue;  // units are counted in int
  const int grid = (int)(most < sm_count() ? most : sm_count());
  gmm_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, stream>>>(a, tx, tw, to);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gmm_launch(const GmmArgs* a, void* stream) {
  // TMA coordinates are int32: the last row tile must start below 2^31
  if (a->e < 1 || a->e > GMM_MAX_EXPERTS || a->k % 8 || a->n % 8 || a->b < 0 ||
      (long long)a->b + BM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (a->b == 0) return 0;  // no rows, nothing to write
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(a->trans_w ? launch<true>(*a, st) : launch<false>(*a, st));
}
