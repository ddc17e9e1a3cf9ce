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
// cores bound it (0.167 ms at 989 TFLOP/s). Design against that: 128 x 128
// output tiles (8 warps, each 64 x 32) keep 64 f32 accumulators a thread and
// reuse each shared operand across four mma tiles; the K loop streams 32-deep
// slices of x and w[e] through a three-stage cp.async ring, read with
// ldmatrix from padded tiles (no bank conflicts). mma.sync bf16, f32 sums.
//
// The tile schedule comes from offsets on the device. grid.y has one slot for
// each (segment, row tile) pair the offsets can make: ceil(B / 128) + E + 1,
// where the E + 2 segments are the head rows [0, offsets[0]), the E groups and
// the tail rows [offsets[E], B). Each block reads the offsets into shared
// memory and walks the segments' tile counts to find its own; a tile that
// straddles a boundary is computed once for each segment, with its rows masked
// on load and store, as MegaBlox does. Blocks past the last tile exit, and
// head/tail tiles only store zeros.
#include "flash_common.cuh"

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

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int PA = BK + 8;     // x tile [BM][PA]
constexpr int PKN = BN + 8;    // w tile [BK][PKN] (w stored [K, N])
constexpr int PNK = BK + 8;    // w tile [BN][PNK] (w stored [N, K])
constexpr int A_STAGE = BM * PA;
constexpr int B_STAGE = BN * PNK > BK * PKN ? BN * PNK : BK * PKN;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);

template <bool TRANS>
__global__ void __launch_bounds__(THREADS) gmm_kernel(const GmmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bnd[GMM_MAX_EXPERTS + 3];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // segment boundaries 0, offsets[0..E], B, clamped monotone into [0, B]
  for (int i = tid; i <= a.e; i += THREADS) bnd[i + 1] = a.offsets[i];
  __syncthreads();
  if (tid == 0) {
    bnd[0] = 0;
    for (int i = 1; i <= a.e + 1; ++i) bnd[i] = min(max(bnd[i], bnd[i - 1]), a.b);
    bnd[a.e + 2] = a.b;
  }
  __syncthreads();

  int slot = blockIdx.y, seg = -1, lo = 0, hi = 0, r0 = 0;
  for (int j = 0; j <= a.e + 1; ++j) {
    const int s0 = bnd[j], s1 = bnd[j + 1];
    if (s1 <= s0) continue;
    const int t0 = s0 / BM, nt = (s1 - 1) / BM - t0 + 1;
    if (slot < nt) {
      seg = j;
      r0 = (t0 + slot) * BM;
      lo = max(s0, r0);
      hi = min(s1, r0 + BM);
      break;
    }
    slot -= nt;
  }
  if (seg < 0) return;
  const int n0 = blockIdx.x * BN;

  if (seg == 0 || seg == a.e + 1) {  // rows of no group
    const int nch = min(BN, a.n - n0) / 8;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < (hi - lo) * nch; i += THREADS) {
      const long long r = lo + i / nch;
      *reinterpret_cast<uint4*>(a.out + r * a.ldo + n0 + (i % nch) * 8) = zero;
    }
    return;
  }

  const bf16* wp = a.w + (long long)(seg - 1) * a.swe;
  const int nk = (a.k + BK - 1) / BK;

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* dA = sA + st * A_STAGE;
    bf16* dB = sB + st * B_STAGE;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int row = r0 + r, col = k0 + c;
      const bool ok = row >= lo && row < hi && col < a.k;
      cp_async16(dA + r * PA + c, ok ? a.x + row * a.ldx + col : a.x, ok);
    }
    if (TRANS) {  // w[e] is [N, K]: rows n0.., columns k0..
      for (int i = tid; i < BN * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int nn = n0 + r, col = k0 + c;
        const bool ok = nn < a.n && col < a.k;
        cp_async16(dB + r * PNK + c, ok ? wp + nn * a.swr + col : wp, ok);
      }
    } else {      // w[e] is [K, N]: rows k0.., columns n0..
      for (int i = tid; i < BK * (BN / 8); i += THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int kk = k0 + r, col = n0 + c;
        const bool ok = kk < a.k && col < a.n;
        cp_async16(dB + r * PKN + c, ok ? wp + kk * a.swr + col : wp, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* cA = sA + (kt % STAGES) * A_STAGE;
    const bf16* cB = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) load_a<PA>(af[mi], cA, wm + mi * 16, kk, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        if (TRANS)
          load_b_nk<PNK>(b, cB, wn + nj * 16, kk, lane);
        else
          load_b_kn<PKN>(b, cB, wn + nj * 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = r0 + wm + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= a.n) continue;
      if (row >= lo && row < hi)
        store_bf16x2(a.out + (long long)row * a.ldo + col, acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 >= lo && row + 8 < hi)
        store_bf16x2(a.out + (long long)(row + 8) * a.ldo + col, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

template <bool TRANS>
cudaError_t launch(const GmmArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gmm_kernel<TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + BN - 1) / BN, (a.b + BM - 1) / BM + a.e + 1);
  gmm_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gmm_launch(const GmmArgs* a, void* stream) {
  if (a->e < 1 || a->e > GMM_MAX_EXPERTS || a->k % 8 || a->n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(a->trans_w ? launch<true>(*a, st) : launch<false>(*a, st));
}
