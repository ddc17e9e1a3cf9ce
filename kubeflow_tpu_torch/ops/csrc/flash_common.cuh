// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu): the argument block passed from Python
// through ctypes; the 4-D tensor maps through which the kernels load and
// store activations by TMA; the descriptor step and register-operand wgmma
// they share; the softmax arithmetic (exp2, bf16 packing, quad reductions);
// and the 4-byte cp.async with which K2 loads its lse and delta rows. The
// TMA, mbarrier and wgmma pieces are hopper_gemm.cuh's.
//
// Layout: every activation is [batch, seq, heads, head_dim] with head_dim
// contiguous; the kernels read and write it through the element strides in
// TensorRef, so the model's tensors need no transpose copies.
#pragma once

#include "hopper_gemm.cuh"

// Must match kubeflow_tpu_torch/ops/flash_attention.py::_TensorRef / _FlashArgs.
struct TensorRef {
  void* ptr;
  long long sb;  // batch stride, in elements
  long long ss;  // sequence stride
  long long sh;  // head stride
};

struct FlashArgs {
  TensorRef q, k, v, o, dout, dq, dk, dv;
  float* lse;    // [batch * heads, seq]: written by the forward, read by the backward
  float* delta;  // [batch * heads, seq]: rowsum(dO * O) - dlse, read by the backward
  int b, s, h, kv, d, causal;
  float scale;   // 1 / sqrt(head_dim)
};

#define FLASH_NEG_INF (-1e30f)  // the reference's mask value (NEG_INF)
#define FLASH_LOG2E 1.4426950408889634f
#define FLASH_LN2 0.6931471805599453f

// A [batch, seq, heads, head_dim] bf16 activation as a 4-D tensor map, dims
// (head_dim, heads, seq, batch) innermost first, read or written in boxes of
// 64 head_dim columns x `rows` positions of one head and one batch row. A box
// that runs past `seq` loads zeros there and stores nothing there, and never
// reaches into the next batch row. The wrapper hands over strides that are
// positive multiples of 16 bytes (flash_attention.py::_kernel_layout).
static bool flash_tensor_map(CUtensorMap* map, const TensorRef& t, int heads, const FlashArgs& a,
                             int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)heads, (cuuint64_t)a.s,
                              (cuuint64_t)a.b};
  const cuuint64_t strides[3] = {(cuuint64_t)t.sh * 2, (cuuint64_t)t.ss * 2,
                                 (cuuint64_t)t.sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_tensor_map(map, t.ptr, 4, dims, strides, box);
}

// Descriptor offset (16-byte units) of k16 step kk in a K-major tile of
// 64-column boxes `box` bytes apart: 32 bytes a step, four steps a box.
__device__ __forceinline__ uint64_t kstep(int kk, int box) {
  return (kk / 4) * (box >> 4) + 2 * (kk % 4);
}

// d (+)= A B over one k16 step with A from registers and B an MN-major tile
// in shared memory: wgmma m64n64k16 or m64n128k16 by the accumulator's width
// (head_dim 64 or 128). P V of the forward, P^T dO and dS^T Q of dK/dV, dS K
// of dQ.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k16_rs<1>(d, a, db, 1);
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k16_rs<1>(d, a, db, 1);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from gmem to smem; when !valid, 0 source bytes: smem is zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// One arrival on `bar` once every earlier cp.async of this thread has landed;
// the barrier's expected count includes it (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}
