// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu): the argument block passed from Python
// through ctypes; the 4-D tensor maps through which the wgmma kernels (K1, K2)
// load and store activations by TMA, and the softmax arithmetic they share
// (exp2, quad reductions); and the PTX wrappers for cp.async, ldmatrix and
// the bf16 mma.sync.m16n8k16 tensor-core product with f32 accumulation, on
// which K3 runs. The TMA, mbarrier and wgmma pieces are hopper_gemm.cuh's.
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

#define FLASH_THREADS 128
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
// (head_dim 64 or 128). P V of the forward, P^T dO and dS^T Q of dK/dV.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// One arrival on `bar` once every earlier cp.async of this thread has landed;
// the barrier's expected count includes it (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i supplies the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16 rows x 16 cols, row-major in shared memory, pitch P elements)
// starting at row m0, column k0.
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int m0, int k0,
                                       int lane) {
  ldsm_x4(a, base + (m0 + (lane & 15)) * P + k0 + (lane >> 4) * 8);
}

// B operands of two adjacent n-tiles (n0, n0 + 8) over k0..k0+15, from a
// shared tile stored [n][k] (k contiguous): b[0], b[1] feed n-tile n0 and
// b[2], b[3] feed n-tile n0 + 8.
template <int P>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* base, int n0, int k0,
                                          int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(b, base + (n0 + (mi >> 1) * 8 + r) * P + k0 + (mi & 1) * 8);
}

// The same from a shared tile stored [k][n] (n contiguous), transposed on load.
template <int P>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* base, int n0, int k0,
                                          int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, base + (k0 + (mi & 1) * 8 + r) * P + n0 + (mi >> 1) * 8);
}

// The accumulators of n-tiles 2j and 2j+1 (16 rows x 16 cols) repacked as the
// bf16 A operand of the next product's k-step j: no trip through shared memory.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy `rows` rows of D bf16 (row stride `stride` elements) into shared memory
// with pitch P; rows at or past `valid` are zero-filled.
template <int D, int P>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int rows,
                                          int valid, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CH; i += FLASH_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * P + c, ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}
