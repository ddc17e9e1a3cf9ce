// K1: causal or non-causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd). Computes O = softmax(scale * Q K^T) V with an online softmax in f32
// and writes lse = m + log(l) per query row as [batch * heads, seq] (the TPU
// kernel's trailing 8-lane axis is a TPU layout artifact and is dropped).
//
// Bound on the H100: at the bench shape (b=14, s=1024, h=kv=8, d=128, causal)
// the function moves ~118 MB and does ~30 GFLOP, so memory bounds it (~35 us
// at 3.35 TB/s) with the tensor cores close behind (~30 us at 989 TFLOP/s).
// Design against that: each K/V tile is read once per 64-row query tile and
// reused by four warps out of shared memory; S and P never leave registers
// (the S accumulator is repacked as the bf16 A operand of P V); the causal
// loop stops at the diagonal tile, so masked tiles cost no bytes or FLOPs;
// the next K/V tile streams in with cp.async while the current one is used.
// Query tiles are launched longest-row first so the diagonal-heavy blocks do
// not form the tail. mma.sync bf16 products with f32 accumulation; wgmma,
// TMA and warp specialisation are later work.
//
// The TPU grid carried (m, l, acc) in scratch across a sequential k axis; here
// the k loop lives inside one thread block and the state lives in registers.
// The ragged last tile (e.g. seq 1023) is masked in the kernel instead of
// padding the sequence.
#include "flash_common.cuh"

namespace {

constexpr int BR = 64;  // query rows per block: 4 warps x 16
constexpr int BC = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(FLASH_THREADS) flash_fwd_kernel(const FlashArgs a) {
  constexpr int P = D + 8;  // padded pitch: conflict-free ldmatrix rows
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BR * P;      // 2 stages
  bf16* sV = sK + 2 * BC * P;  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = a.s;
  const int nq = (s + BR - 1) / BR;
  const int q0 = (nq - 1 - blockIdx.x) * BR;
  const int bh = blockIdx.y, bi = bh / a.h, hi = bh % a.h, kvi = hi / (a.h / a.kv);

  const bf16* qp = static_cast<const bf16*>(a.q.ptr) + bi * a.q.sb + hi * a.q.sh;
  const bf16* kp = static_cast<const bf16*>(a.k.ptr) + bi * a.k.sb + kvi * a.k.sh;
  const bf16* vp = static_cast<const bf16*>(a.v.ptr) + bi * a.v.sb + kvi * a.v.sh;

  const int last_key = a.causal ? min(q0 + BR - 1, s - 1) : s - 1;
  const int nk = last_key / BC + 1;

  load_rows<D, P>(sQ, qp + q0 * a.q.ss, a.q.ss, BR, s - q0, tid);
  cp_async_commit();
  load_rows<D, P>(sK, kp, a.k.ss, BC, s, tid);
  load_rows<D, P>(sV, vp, a.v.ss, BC, s, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<P>(qf[kk], sQ, warp * 16, kk * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = FLASH_NEG_INF, m1 = FLASH_NEG_INF, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      const int st = (j + 1) & 1, k1 = (j + 1) * BC;
      load_rows<D, P>(sK + st * BC * P, kp + k1 * a.k.ss, a.k.ss, BC, s - k1, tid);
      load_rows<D, P>(sV + st * BC * P, vp + k1 * a.v.ss, a.v.ss, BC, s - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + (j & 1) * BC * P;
    const bf16* cV = sV + (j & 1) * BC * P;
    const int k0 = j * BC;

    float sc[BC / 8][4];
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < BC / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, cK, n2 * 16, kk * 16, lane);
        mma_bf16(sc[2 * n2], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], qf[kk], b[2], b[3]);
      }
    }

    const bool need_mask = (a.causal && k0 + BC - 1 > q0) || k0 + BC > s;
    float mx0 = FLASH_NEG_INF, mx1 = FLASH_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the reference scales q in f32 before an f32 product; scaling the
        // f32 accumulator is that arithmetic without rounding q * scale to bf16
        float x = sc[nt][e] * a.scale;
        if (need_mask) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (col >= s || (a.causal && col > row)) x = FLASH_NEG_INF;
        }
        sc[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      sc[nt][0] = __expf(sc[nt][0] - mn0);
      sc[nt][1] = __expf(sc[nt][1] - mn0);
      sc[nt][2] = __expf(sc[nt][2] - mn1);
      sc[nt][3] = __expf(sc[nt][3] - mn1);
      ls0 += sc[nt][0] + sc[nt][1];
      ls1 += sc[nt][2] + sc[nt][3];
    }
    // l stays a per-thread partial sum; the quad reduces it once at the end
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, cV, d2 * 16, kk * 16, lane);
        mma_bf16(o[2 * d2], pa, b[0], b[1]);
        mma_bf16(o[2 * d2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* op = static_cast<bf16*>(a.o.ptr) + bi * a.o.sb + hi * a.o.sh;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row0 < s) store_bf16x2(op + row0 * a.o.ss + i * 8 + col, o[i][0] * inv0, o[i][1] * inv0);
    if (row1 < s) store_bf16x2(op + row1 * a.o.ss + i * 8 + col, o[i][2] * inv1, o[i][3] * inv1);
  }
  if ((lane & 3) == 0) {
    float* lse = a.lse + (long long)bh * s;
    if (row0 < s) lse[row0] = m0 + logf(l0);
    if (row1 < s) lse[row1] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int P = D + 8;
  const int smem = (BR + 4 * BC) * P * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BR - 1) / BR, a.b * a.h);
  flash_fwd_kernel<D><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
