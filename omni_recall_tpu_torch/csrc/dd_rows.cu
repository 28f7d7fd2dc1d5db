// Hand-written Hopper (sm_90a) kernel for the device-exact cosine (K2).
//
// Replaces _dd_rows_kernel / _dd_rows_pallas of omni_recall_tpu/ops/exact_cos.py (the
// TPU kernel that evaluates dd_sum_products over gathered candidate rows). For each
// (query b, candidate slot t) it reads the candidate row straight from the raw f32
// plane by index (rows < 0 read row 0, as jnp.maximum(rows, 0) does; so do rows
// >= N, which no caller passes, so no launch reads outside the plane), forms the f32
// products p_i = q_i * c_i, zero-pads them to the next power of two P and folds by
// halving, pairing (i, i + P/2), with Knuth TwoSum and lo_new = e + (l1 + l2)
// followed by a second TwoSum, exactly as _dd_fold / dd_sum_products do. hi and lo
// are therefore bit-identical to the JAX graph; sabs = sum |p_i| is taken in tree
// order, which SABS_REL covers for any order.
//
// What bounds it on the H100: the gathered bytes, B*t*d*4 (44 MB at B = 448, t = 32,
// d = 768, 13 us at 3.35 TB/s); the fold's ~15 f32 operations per element are far
// below the 67 TFLOP/s f32 rate. Design: one block per (query, slot) pair, so the
// candidate row is read once, contiguously, straight into shared memory (no [B, t, d]
// gather in device memory, which the TPU version also avoided), and the fold levels
// live in shared memory (2 * P * 4 bytes). Every add is __fadd_rn / __fsub_rn and the
// library builds with -fmad=false: no contraction, no reassociation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
}

__global__ void dd_rows_kernel(const float* __restrict__ raw, const int32_t* __restrict__ rows,
                               const float* __restrict__ q, float* __restrict__ hi_out,
                               float* __restrict__ lo_out, float* __restrict__ sabs_out,
                               int n, int d, int t, int p) {
  extern __shared__ float sm[];
  float* h = sm;
  float* l = sm + p;
  __shared__ float warp_sums[32];

  const int pair = blockIdx.x;
  const int bi = pair / t;
  int row = rows[pair];
  if (row < 0 || row >= n) row = 0;  // empty slot (and never out of bounds)
  const float* c = raw + (size_t)row * d;
  const float* qq = q + (size_t)bi * d;

  float sabs = 0.0f;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    float prod = 0.0f;
    if (i < d) {
      prod = __fmul_rn(qq[i], c[i]);
      sabs = __fadd_rn(sabs, fabsf(prod));
    }
    h[i] = prod;
    l[i] = 0.0f;
  }
  __syncthreads();

  for (int half = p >> 1; half >= 1; half >>= 1) {
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      float s, e, s2, e2;
      two_sum(h[i], h[i + half], s, e);
      const float lo_new = __fadd_rn(e, __fadd_rn(l[i], l[i + half]));
      two_sum(s, lo_new, s2, e2);
      h[i] = s2;
      l[i] = e2;
    }
    __syncthreads();
  }

  for (int o = 16; o > 0; o >>= 1) sabs = __fadd_rn(sabs, __shfl_xor_sync(0xffffffffu, sabs, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sabs;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    hi_out[pair] = h[0];
    lo_out[pair] = l[0];
    sabs_out[pair] = total;
  }
}

}  // namespace

// raw f32[n, d], rows i32[b, t], q f32[b, d] -> hi, lo, sabs f32[b, t]
extern "C" int omni_dd_rows(const void* raw, const void* rows, const void* q, void* hi,
                            void* lo, void* sabs, int n, int d, int b, int t, void* stream) {
  if (n <= 0 || d <= 0 || b <= 0 || t <= 0) return -1;
  int p = 1;
  while (p < d) p *= 2;
  const size_t smem = (size_t)2 * p * sizeof(float);
  if (smem + 32 * sizeof(float) > (size_t)kMaxSmem) return -1;  // + warp_sums
  int threads = p / 2;
  if (threads < 32) threads = 32;
  if (threads > 512) threads = 512;
  cudaError_t err = cudaFuncSetAttribute(dd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dd_rows_kernel<<<(unsigned)((size_t)b * t), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw), static_cast<const int32_t*>(rows),
      static_cast<const float*>(q), static_cast<float*>(hi), static_cast<float*>(lo),
      static_cast<float*>(sabs), n, d, t, p);
  return (int)cudaGetLastError();
}

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
