// K4b: transposed grouped matrix multiply (the weight gradient of K4a), for
// Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/grouped_matmul.py::_vjp_bwd's MegaBlox ``tgmm``:
//   dw[e] = x[offsets[e]:offsets[e+1]]^T @ g[offsets[e]:offsets[e+1]],
// with x [B, K], g [B, N] and dw [E, K, N]. An empty group's block is zeros.
//
// Bound on the H100: at the MoE bench shape (B = 28,644, K = 1024, N = 2816,
// E = 8) one launch is 165 GFLOP against 0.27 GB, so the tensor cores bound
// it (0.167 ms at 989 TFLOP/s). Design against that:
// - One owner per output tile: a unit is one 128 x 256 tile of one dw[e]; its
//   block reduces over the group's rows in 64-row slices with the sum in
//   registers (two consumer warpgroups of 64 dw rows, 128 f32 accumulators a
//   thread). No atomics, no second pass: the result is deterministic.
// - Tensor cores through wgmma m64n256k16. A is x_e^T and B is g_e, both read
//   as they lie in memory ([rows, K] and [rows, N]): MN-major operands, the
//   transpose bit set, so x is never transposed in device memory.
// - Loads through TMA: one producer thread keeps a three-stage ring of slices
//   (two 64 x 64 boxes of x, four of g, 128-byte swizzle) in flight, tracked
//   by full/empty mbarriers; the producer warpgroup gives its registers to
//   the consumers (setmaxnreg). A slice starts at any row (TMA coordinates
//   need no alignment), so the first starts exactly at offsets[e].
// - The last slice of a group reads rows of the next group (or past
//   offsets[E]), which TMA cannot mask: before its products the consumer
//   warpgroups zero those rows of x and of g in shared memory (one 128-byte
//   line a row and box, whatever the swizzle), each its own x half and two of
//   the four g boxes, fence the generic-proxy stores for wgmma and meet at one
//   barrier. Both operands, so that an Inf or NaN there cannot reach the
//   group's sums as 0 * Inf.
// - A persistent grid: min(#SMs, units) blocks walk the units with a static
//   stride, groups ordered largest first (each block sorts the E group sizes
//   from the offsets on the device), so the longest units start first and
//   the short ones fill the tail. Empty groups' units store zeros.
// - The epilogue stages each warpgroup's 64 x 256 tile in shared memory and
//   one thread stores it by TMA (clipped at K and N), which runs on while the
//   next unit's products start.
#include "hopper_gemm.cuh"

// Must match kubeflow_tpu_torch/ops/grouped_matmul.py::_TgmmArgs.
struct TgmmArgs {
  const bf16* x;       // [B, K], row stride ldx
  long long ldx;
  const bf16* g;       // [B, N], row stride ldg
  long long ldg;
  bf16* dw;            // [E, K, N], contiguous
  const int* offsets;  // [E + 1], int32 on the device
  int b, k, n, e;
};

#define TGMM_MAX_EXPERTS 256  // grouped_matmul.py::MAX_EXPERTS

namespace {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int THREADS = 384;                 // producer warpgroup + two consumer warpgroups
constexpr int BOX = 64 * BK * 2;             // one 64-row x 64-column box: 8 KB
constexpr int A_BYTES = 2 * BOX;             // x slice: 64 rows x 128 columns
constexpr int B_BYTES = (BN / 64) * BOX;     // g slice: 64 rows x 256 columns
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BYTES = BM * BN * 2;       // the dw tile, staged for the TMA store

struct Sched {
  uint64_t full[STAGES], empty[STAGES];
  int lo[TGMM_MAX_EXPERTS];     // group rows [lo, lo + size), clamped into [0, B]
  int size[TGMM_MAX_EXPERTS];
  int order[TGMM_MAX_EXPERTS];  // groups, largest first (ties by index)
};
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + (int)sizeof(Sched);

__global__ void __launch_bounds__(THREADS, 1)
    tgmm_kernel(const TgmmArgs a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tdw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* staged = ring + STAGES * STAGE_BYTES;
  Sched& s = *reinterpret_cast<Sched*>(staged + OUT_BYTES);
  const int tid = threadIdx.x;

  for (int i = tid; i < a.e; i += THREADS) {
    const int lo = min(max(a.offsets[i], 0), a.b);
    s.lo[i] = lo;
    s.size[i] = min(max(a.offsets[i + 1], lo), a.b) - lo;
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);   // the producer's arrival + the TMA bytes
      mbar_init(&s.empty[i], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int i = tid; i < a.e; i += THREADS) {
    int rank = 0;
    for (int j = 0; j < a.e; ++j)
      rank += s.size[j] > s.size[i] || (s.size[j] == s.size[i] && j < i);
    s.order[rank] = i;
  }
  __syncthreads();
  const int ntn = (a.n + BN - 1) / BN, per_group = ((a.k + BM - 1) / BM) * ntn;
  const int units = a.e * per_group;

  if (tid < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int grp = s.order[u / per_group], r = u % per_group;
        const int m0 = (r / ntn) * BM, n0 = (r % ntn) * BN;
        const int lo = s.lo[grp], hi = lo + s.size[grp];
        const int xboxes = min(2, (a.k - m0 + 63) / 64), gboxes = min(BN / 64, (a.n - n0 + 63) / 64);
        for (int row = lo; row < hi; row += BK) {
          mbar_wait(&s.empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(&s.full[stage], (xboxes + gboxes) * BOX);
          for (int i = 0; i < xboxes; ++i)
            tma_load_2d(st + i * BOX, &tx, &s.full[stage], m0 + 64 * i, row);
          for (int i = 0; i < gboxes; ++i)
            tma_load_2d(st + A_BYTES + i * BOX, &tg, &s.full[stage], n0 + 64 * i, row);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the dw tile each
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, t = tid % 128;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int grp = s.order[u / per_group], r = u % per_group;
      const int m0 = (r / ntn) * BM, n0 = (r % ntn) * BN;
      const int lo = s.lo[grp], hi = lo + s.size[grp];
      bf16* dw = a.dw + (long long)grp * a.k * a.n;
      if (hi <= lo) {  // empty group: its tile is zeros
        store_zeros(dw, a.n, m0, min(m0 + BM, a.k), n0, min(n0 + BN, a.n), tid - 128, 256);
        continue;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int row = lo; row < hi; row += BK) {
        mbar_wait(&s.full[stage], phase);
        unsigned char* st = ring + stage * STAGE_BYTES;
        unsigned char* xs = st + cw * BOX;  // this warpgroup's 64 dw rows: x columns m0 + 64 cw..
        const int valid = hi - row;
        if (valid < BK) {  // rows past the group: zero them in x and g, for wgmma
          const int lines = (BK - valid) * 8;  // 16-byte chunks of those rows in one box
          for (int i = t; i < 3 * lines; i += 128) {  // x half cw, g boxes 2 cw and 2 cw + 1
            const int box = i / lines, j = i % lines;
            unsigned char* p = box == 0 ? xs : st + A_BYTES + (2 * cw + box - 1) * BOX;
            *reinterpret_cast<uint4*>(p + (valid + j / 8) * 128 + (j % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          named_bar_sync(3, 256);  // both warpgroups read all of g
        }
        const uint64_t da = sw128_desc(xs, BOX, 1024);
        const uint64_t db = sw128_desc(st + A_BYTES, BOX, 1024);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // k16 steps: 16 rows, 2,048 bytes
          wgmma_m64n256k16<1, 1>(acc, da + 128 * kk, db + 128 * kk, 1);
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
      const int row0 = m0 + 64 * cw;  // this warpgroup's 64 dw rows
      if (row0 >= a.k) continue;
      // stage the tile; one thread stores it by TMA (clipped at K and N)
      unsigned char* own = staged + cw * (OUT_BYTES / 2);
      if (t == 0) tma_store_wait_read();  // the last unit's store has read `own`
      named_bar_sync(1 + cw, 128);
      acc_to_smem<BN>(acc, own, t);
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (t == 0) {
        for (int i = 0; i < BN / 64 && n0 + 64 * i < a.n; ++i)
          tma_store_3d(&tdw, own + i * BOX, n0 + 64 * i, row0, grp);
        tma_store_commit();
      }
    }
    if (t == 0) tma_store_wait();  // before the block's shared memory goes away
  }
}

}  // namespace

extern "C" int tgmm_launch(const TgmmArgs* a, void* stream) {
  // TMA coordinates are int32: the last slice must start below 2^31
  if (a->e < 1 || a->e > TGMM_MAX_EXPERTS || a->k % 8 || a->n % 8 || a->b < 0 ||
      (long long)a->b + BK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->b == 0)  // every group is empty
    return (int)cudaMemsetAsync(a->dw, 0, (size_t)a->e * a->k * a->n * sizeof(bf16), st);
  CUtensorMap tx, tg, tdw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)a->k, (cuuint64_t)a->b};
  const cuuint64_t x_strides[1] = {(cuuint64_t)a->ldx * 2};
  const cuuint64_t g_dims[2] = {(cuuint64_t)a->n, (cuuint64_t)a->b};
  const cuuint64_t g_strides[1] = {(cuuint64_t)a->ldg * 2};
  const cuuint32_t box[2] = {64, BK};
  const cuuint64_t dw_dims[3] = {(cuuint64_t)a->n, (cuuint64_t)a->k, (cuuint64_t)a->e};
  const cuuint64_t dw_strides[2] = {(cuuint64_t)a->n * 2, (cuuint64_t)a->k * a->n * 2};
  const cuuint32_t dw_box[3] = {64, 64, 1};
  if (!make_tensor_map(&tx, a->x, 2, x_dims, x_strides, box) ||
      !make_tensor_map(&tg, a->g, 2, g_dims, g_strides, box) ||
      !make_tensor_map(&tdw, a->dw, 3, dw_dims, dw_strides, dw_box))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES];
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(tgmm_kernel), SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)a->e * ((a->k + BM - 1) / BM) * ((a->n + BN - 1) / BN);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // units are counted in int
  const int grid = (int)(units < sm_count() ? units : sm_count());
  tgmm_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(*a, tx, tg, tdw);
  return (int)cudaGetLastError();
}
