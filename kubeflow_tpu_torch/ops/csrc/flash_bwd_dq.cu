// K3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched in
// _bwd). For each 64-row query tile it loops over the key tiles (up to the
// diagonal when causal) and accumulates
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta),  dQ += dS K,
// and writes dQ = scale * sum in bf16. delta = rowsum(dO * O) - dlse comes
// from the caller, as in the reference.
//
// Bound on the H100: three tile products per (query, key) pair; at the bench
// shape ~45 GFLOP against ~177 MB of traffic, so the tensor cores bound it
// (~46 us at 989 TFLOP/s). Design against that: one block owns a query tile,
// so dQ accumulates in registers and is written once with no atomics; Q and
// dO stay in shared memory for the whole key loop, K/V tiles stream through a
// two-stage cp.async ring; P and dS never leave registers (accumulators are
// repacked as bf16 A operands). mma.sync bf16 with f32 accumulation.
#include "flash_common.cuh"

namespace {

constexpr int BR = 64;  // query rows per block: 4 warps x 16
constexpr int BC = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(FLASH_THREADS) flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BR * P;
  bf16* sK = sdO + BR * P;     // 2 stages
  bf16* sV = sK + 2 * BC * P;  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = a.s;
  const int nq = (s + BR - 1) / BR;
  const int q0 = (nq - 1 - blockIdx.x) * BR;
  const int bh = blockIdx.y, bi = bh / a.h, hi = bh % a.h, kvi = hi / (a.h / a.kv);

  const bf16* qp = static_cast<const bf16*>(a.q.ptr) + bi * a.q.sb + hi * a.q.sh;
  const bf16* dop = static_cast<const bf16*>(a.dout.ptr) + bi * a.dout.sb + hi * a.dout.sh;
  const bf16* kp = static_cast<const bf16*>(a.k.ptr) + bi * a.k.sb + kvi * a.k.sh;
  const bf16* vp = static_cast<const bf16*>(a.v.ptr) + bi * a.v.sb + kvi * a.v.sh;

  const int last_key = a.causal ? min(q0 + BR - 1, s - 1) : s - 1;
  const int nk = last_key / BC + 1;

  load_rows<D, P>(sQ, qp + q0 * a.q.ss, a.q.ss, BR, s - q0, tid);
  load_rows<D, P>(sdO, dop + q0 * a.dout.ss, a.dout.ss, BR, s - q0, tid);
  load_rows<D, P>(sK, kp, a.k.ss, BC, s, tid);
  load_rows<D, P>(sV, vp, a.v.ss, BC, s, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const float* lse = a.lse + (long long)bh * s;
  const float* delta = a.delta + (long long)bh * s;
  const float lse0 = row0 < s ? lse[row0] : 0.f, lse1 = row1 < s ? lse[row1] : 0.f;
  const float dl0 = row0 < s ? delta[row0] : 0.f, dl1 = row1 < s ? delta[row1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

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

    // S = Q K^T and dP = dO V^T over the same 16 x 64 warp tile
    float sc[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) {
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<P>(qa, sQ, warp * 16, kk * 16, lane);
      load_a<P>(da, sdO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < BC / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, cK, n2 * 16, kk * 16, lane);
        mma_bf16(sc[2 * n2], qa, b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], qa, b[2], b[3]);
        load_b_nk<P>(b, cV, n2 * 16, kk * 16, lane);
        mma_bf16(dp[2 * n2], da, b[0], b[1]);
        mma_bf16(dp[2 * n2 + 1], da, b[2], b[3]);
      }
    }

    const bool need_mask = (a.causal && k0 + BC - 1 > q0) || k0 + BC > s || q0 + BR > s;
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        float p = __expf(sc[nt][e] * a.scale - (e < 2 ? lse0 : lse1));
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (col >= s || row >= s || (a.causal && col > row)) p = 0.f;
        }
        sc[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));  // dS (scale applied at the end)
      }
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t ds[4];
      acc_to_a(ds, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, cK, d2 * 16, kk * 16, lane);
        mma_bf16(dq[2 * d2], ds, b[0], b[1]);
        mma_bf16(dq[2 * d2 + 1], ds, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* out = static_cast<bf16*>(a.dq.ptr) + bi * a.dq.sb + hi * a.dq.sh;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row0 < s)
      store_bf16x2(out + row0 * a.dq.ss + i * 8 + col, dq[i][0] * a.scale, dq[i][1] * a.scale);
    if (row1 < s)
      store_bf16x2(out + row1 * a.dq.ss + i * 8 + col, dq[i][2] * a.scale, dq[i][3] * a.scale);
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int P = D + 8;
  const int smem = (2 * BR + 4 * BC) * P * (int)sizeof(bf16);
  static bool smem_set[MAX_DEVICES];  // one record per instantiation
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>), smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BR - 1) / BR, a.b * a.h);
  flash_bwd_dq_kernel<D><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
