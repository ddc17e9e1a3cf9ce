// K4b: transposed grouped matrix multiply (the weight gradient of K4a), for
// Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/grouped_matmul.py::_vjp_bwd's MegaBlox ``tgmm``:
//   dw[e] = x[offsets[e]:offsets[e+1]]^T @ g[offsets[e]:offsets[e+1]],
// with x [B, K], g [B, N] and dw [E, K, N]. An empty group's block is zeros.
//
// Bound on the H100: at the MoE bench shape (B = 28,644, K = 1024, N = 2816,
// E = 8) one launch is 165 GFLOP against 0.27 GB, so the tensor cores bound
// it (0.167 ms at 989 TFLOP/s). Design against that: one block owns one
// 128 x 128 tile of dw[e] (grid: N tiles x K tiles x E) and loops over its
// group's rows in 32-row slices, so the sum stays in registers (64 f32 a
// thread, 8 warps of 64 x 32): no atomics and no second pass. The slices of x
// and g stream through a three-stage cp.async ring; the slice of x lands in
// shared memory row-major ([row][k]) and ldmatrix.trans hands it to mma.sync
// as the transposed A operand, so x is never transposed in device memory. The
// last slice of a group is ragged and zero-filled past the group's end.
//
// Skewed routing leaves the load unbalanced: every block of a large group
// loops over all of its rows while the blocks of small groups finish early.
// Splitting long groups over several blocks is the first target of a later
// change.
#include "flash_common.cuh"

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

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int PM = BM + 8;  // x slice [BK][PM]
constexpr int PN = BN + 8;  // g slice [BK][PN]
constexpr int A_STAGE = BK * PM, B_STAGE = BK * PN;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);

// A operand (16 x 16, A[m][k]) of mma.sync from a shared tile stored [k][m]
// (m contiguous), transposed on load.
template <int P>
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4], const bf16* base, int m0, int k0,
                                          int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4_t(a, base + (k0 + (mi >> 1) * 8 + r) * P + m0 + (mi & 1) * 8);
}

__global__ void __launch_bounds__(THREADS) tgmm_kernel(const TgmmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int lo = min(max(a.offsets[e], 0), a.b);
  const int hi = min(max(a.offsets[e + 1], lo), a.b);
  bf16* dwp = a.dw + (long long)e * a.k * a.n;

  if (hi <= lo) {  // empty group: its block is zeros
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int m = m0 + i / (BN / 8), c = n0 + (i % (BN / 8)) * 8;
      if (m < a.k && c < a.n) *reinterpret_cast<uint4*>(dwp + (long long)m * a.n + c) = zero;
    }
    return;
  }

  const int nc = (hi - lo + BK - 1) / BK;
  auto load_stage = [&](int ct, int st) {
    const int row0 = lo + ct * BK;
    bf16* dA = sA + st * A_STAGE;
    bf16* dB = sB + st * B_STAGE;
    for (int i = tid; i < BK * (BM / 8); i += THREADS) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const int row = row0 + r, col = m0 + c;
      const bool ok = row < hi && col < a.k;
      cp_async16(dA + r * PM + c, ok ? a.x + row * a.ldx + col : a.x, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int row = row0 + r, col = n0 + c;
      const bool ok = row < hi && col < a.n;
      cp_async16(dB + r * PN + c, ok ? a.g + row * a.ldg + col : a.g, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) load_stage(s, s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  for (int ct = 0; ct < nc; ++ct) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice ct landed; every warp is done with slice ct - 1
    if (ct + STAGES - 1 < nc) load_stage(ct + STAGES - 1, (ct + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* cA = sA + (ct % STAGES) * A_STAGE;
    const bf16* cB = sB + (ct % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) load_a_km<PM>(af[mi], cA, wm + mi * 16, kk, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        load_b_kn<PN>(b, cB, wn + nj * 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = m0 + wm + mi * 16 + gr;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= a.n) continue;
      if (m < a.k) store_bf16x2(dwp + (long long)m * a.n + col, acc[mi][ni][0], acc[mi][ni][1]);
      if (m + 8 < a.k)
        store_bf16x2(dwp + (long long)(m + 8) * a.n + col, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

}  // namespace

extern "C" int tgmm_launch(const TgmmArgs* a, void* stream) {
  if (a->e < 1 || a->k % 8 || a->n % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tgmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a->n + BN - 1) / BN, (a->k + BM - 1) / BM, a->e);
  tgmm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
