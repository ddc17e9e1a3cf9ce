// K2: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_bwd_dkv_kernel (launched in
// _bwd). One block owns a 64-key tile of one KV head. It loops over the g
// query heads of that KV group and over the query tiles (from the diagonal on
// when causal), recomputes P^T = exp(scale * K Q^T - lse) and accumulates
//   dV += P^T dO,  dS^T = P^T * (V dO^T - delta),  dK += dS^T Q,
// then writes dK = scale * sum and dV in bf16, per KV head. The reference
// wrote per query head and summed the groups afterwards; summing inside the
// block needs no g-times buffer and no atomics.
//
// Bound on the H100: four tile products per (query, key) pair; at the bench
// shape ~60 GFLOP against ~177 MB, so the tensor cores bound it (~61 us at
// 989 TFLOP/s). Design against that: K and V stay in shared memory for the
// whole loop and dK/dV accumulate in registers (each warp owns 16 keys);
// query tiles of 32 rows (Q, dO, lse, delta) stream through a two-stage
// cp.async ring; P^T and dS^T never leave registers. mma.sync bf16 with f32
// accumulation.
#include "flash_common.cuh"

namespace {

constexpr int BC = 64;  // keys per block: 4 warps x 16
constexpr int BQ = 32;  // query rows per streamed tile

template <int D>
__global__ void __launch_bounds__(FLASH_THREADS) flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BC * P;
  bf16* sQ = sV + BC * P;        // 2 stages
  bf16* sdO = sQ + 2 * BQ * P;   // 2 stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * P);  // 2 stages of lse
  float* sD = sL + 2 * BQ;                                 // 2 stages of delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = a.s, g = a.h / a.kv;
  const int k0 = blockIdx.x * BC;
  const int bkv = blockIdx.y, bi = bkv / a.kv, kvi = bkv % a.kv;

  const bf16* kp = static_cast<const bf16*>(a.k.ptr) + bi * a.k.sb + kvi * a.k.sh;
  const bf16* vp = static_cast<const bf16*>(a.v.ptr) + bi * a.v.sb + kvi * a.v.sh;

  // (query head, query tile) pairs this block visits, flattened for the ring
  const int qt_first = a.causal ? k0 / BQ : 0;
  const int ntq = (s + BQ - 1) / BQ - qt_first;
  const int n_it = g * ntq;

  auto load_q_tile = [&](int it, int st) {
    const int hi = kvi * g + it / ntq, q0 = (qt_first + it % ntq) * BQ;
    const bf16* qp = static_cast<const bf16*>(a.q.ptr) + bi * a.q.sb + hi * a.q.sh;
    const bf16* dop = static_cast<const bf16*>(a.dout.ptr) + bi * a.dout.sb + hi * a.dout.sh;
    load_rows<D, P>(sQ + st * BQ * P, qp + q0 * a.q.ss, a.q.ss, BQ, s - q0, tid);
    load_rows<D, P>(sdO + st * BQ * P, dop + q0 * a.dout.ss, a.dout.ss, BQ, s - q0, tid);
    const long long rowbase = (long long)(bi * a.h + hi) * s;
    if (tid < BQ) {
      const bool ok = q0 + tid < s;
      cp_async4(sL + st * BQ + tid, a.lse + rowbase + (ok ? q0 + tid : 0), ok);
    } else if (tid < 2 * BQ) {
      const int r = tid - BQ;
      const bool ok = q0 + r < s;
      cp_async4(sD + st * BQ + r, a.delta + rowbase + (ok ? q0 + r : 0), ok);
    }
  };

  load_rows<D, P>(sK, kp + k0 * a.k.ss, a.k.ss, BC, s - k0, tid);
  load_rows<D, P>(sV, vp + k0 * a.v.ss, a.v.ss, BC, s - k0, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + (lane >> 2), key1 = key0 + 8;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const bf16* cQ = sQ + st * BQ * P;
    const bf16* cdO = sdO + st * BQ * P;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;
    const int q0 = (qt_first + it % ntq) * BQ;

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys x 32 queries
    float sc[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<P>(ka, sK, warp * 16, kk * 16, lane);
      load_a<P>(va, sV, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        uint32_t b[4];
        load_b_nk<P>(b, cQ, n2 * 16, kk * 16, lane);
        mma_bf16(sc[2 * n2], ka, b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], ka, b[2], b[3]);
        load_b_nk<P>(b, cdO, n2 * 16, kk * 16, lane);
        mma_bf16(dp[2 * n2], va, b[0], b[1]);
        mma_bf16(dp[2 * n2 + 1], va, b[2], b[3]);
      }
    }

    const bool need_mask = (a.causal && q0 < k0 + BC - 1) || q0 + BQ > s || k0 + BC > s;
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key0 : key1;
        const int qc = nt * 8 + 2 * (lane & 3) + (e & 1);  // query column in the tile
        float p = __expf(sc[nt][e] * a.scale - cL[qc]);
        if (need_mask) {
          const int q = q0 + qc;
          if (q >= s || key >= s || (a.causal && q < key)) p = 0.f;
        }
        sc[nt][e] = p;                       // P^T
        dp[nt][e] = p * (dp[nt][e] - cD[qc]);  // dS^T (scale applied at the end)
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t b[4];
        load_b_kn<P>(b, cdO, d2 * 16, kk * 16, lane);
        mma_bf16(dv[2 * d2], pa, b[0], b[1]);
        mma_bf16(dv[2 * d2 + 1], pa, b[2], b[3]);
        load_b_kn<P>(b, cQ, d2 * 16, kk * 16, lane);
        mma_bf16(dk[2 * d2], da, b[0], b[1]);
        mma_bf16(dk[2 * d2 + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dkp = static_cast<bf16*>(a.dk.ptr) + bi * a.dk.sb + kvi * a.dk.sh;
  bf16* dvp = static_cast<bf16*>(a.dv.ptr) + bi * a.dv.sb + kvi * a.dv.sh;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (key0 < s) {
      store_bf16x2(dkp + key0 * a.dk.ss + i * 8 + col, dk[i][0] * a.scale, dk[i][1] * a.scale);
      store_bf16x2(dvp + key0 * a.dv.ss + i * 8 + col, dv[i][0], dv[i][1]);
    }
    if (key1 < s) {
      store_bf16x2(dkp + key1 * a.dk.ss + i * 8 + col, dk[i][2] * a.scale, dk[i][3] * a.scale);
      store_bf16x2(dvp + key1 * a.dv.ss + i * 8 + col, dv[i][2], dv[i][3]);
    }
  }
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int P = D + 8;
  const int smem =
      (2 * BC + 4 * BQ) * P * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + BC - 1) / BC, a.b * a.kv);
  flash_bwd_dkv_kernel<D><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dkv_launch(const FlashArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->d == 64) return (int)launch<64>(*a, st);
  if (a->d == 128) return (int)launch<128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
