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
// are therefore bit-identical to the JAX graph; sabs = sum |p_i| is taken in another
// order, which SABS_REL covers for any order.
//
// What bounds it on the H100: the gathered bytes, B*t*d*4 (44 MB at B = 448, t = 32,
// d = 768: 13.6 us at 3.35 TB/s). Beside them the fold is not free: 14 f32 adds for
// each of the P - 1 tree nodes, about half the byte time at the card's add rate, so no
// lane may sit idle through the tree and no barrier may stall it.
//
// Design: one warp folds one pair (G warps for P > 1024), entirely in registers.
// Thread T of the pair's 32*G holds the elements T + 32*G*i, i < R = P / (32*G), read
// as coalesced 128-byte warp loads, all issued before any use. Then
//   - the levels half >= 32*G pair register i with register i + half/(32*G) of the same
//     thread;
//   - the levels 32 <= half < 32*G (G > 1 only) pair thread T with thread T + half
//     through shared memory, a named barrier per level for the pair's warps;
//   - the levels half = 16 ... 1 pair lane L with lane L + half by __shfl_down_sync.
// These are the halving tree's operand pairs in its order (tests/
// test_torch_dd_refine_order.py holds a model of this layout bitwise against
// dd_sum_products), with padding elements folded as the zeros they are. One scalar per
// lane (not a float4) keeps the shuffle levels at one fold a lane, and the register
// levels are a template (fold_registers), so that every index is a constant and the
// arrays stay in registers (nested loops over half left them in local memory). A block
// holds four warps on slots of one query, whose row it stages once in shared memory;
// each warp folds two slots in turn, loading the second row while it folds the first.
// Every add is __fadd_rn / __fsub_rn and the library builds with -fmad=false: no
// contraction, no reassociation.
//
// Two entries share that fold (one device function, dd_rows_body): omni_dd_rows reads
// each row from the raw plane by index (the single-device path), omni_dd_rows_gathered
// reads row (b, j) of rows already gathered, c f32[B, t, d] (the JAX kernel's own
// interface, dd_rows(q_raw, c); the row-sharded path, which gathers each candidate on
// the shard that owns it). On the same rows the two give the same hi, lo and sabs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPad = 16384;     // the largest fold: 16 warps of 32 registers
constexpr int kBlockWarps = 4;     // warps of a block whose pairs take one warp each
constexpr int kSlotsPerWarp = 2;   // slots a warp folds in turn (the next row in flight)

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
}

// one node of the halving tree: (h, l) <- (h, l) folded with its partner (hp, lp)
__device__ __forceinline__ void dd_fold(float& h, float& l, float hp, float lp) {
  float s, e;
  two_sum(h, hp, s, e);
  two_sum(s, __fadd_rn(e, __fadd_rn(l, lp)), h, l);
}

// the register levels of a thread, half = H, H / 2, ..., 1: register i with register
// i + half (a template, so that every index is a constant and the arrays stay in registers)
template <int H, int R>
__device__ __forceinline__ void fold_registers(float (&h)[R], float (&l)[R]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) dd_fold(h[i], l[i], h[i + H], l[i + H]);
    fold_registers<H / 2>(h, l);
  }
}

__device__ __forceinline__ void pair_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

struct DdArgs {
  const float* raw;
  const int32_t* rows;
  const float* q;
  float* hi;
  float* lo;
  float* sabs;
  int n, d, t, p, slots_per_block;
};

// kGathered: a.raw is the gathered c f32[B, t, d] and slot (bi, j) its row
template <bool kGathered, int R>
__device__ __forceinline__ void load_row(const DdArgs& a, int bi, int j, int thread, int span,
                                         float (&c)[R]) {
  const float* cr;
  if constexpr (kGathered) {
    cr = a.raw + ((size_t)bi * a.t + j) * a.d;
  } else {
    int row = a.rows[(size_t)bi * a.t + j];
    if (row < 0 || row >= a.n) row = 0;  // empty slot (and never out of bounds)
    cr = a.raw + (size_t)row * a.d;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = thread + span * i;
    c[i] = e < a.d ? __ldg(cr + e) : 0.0f;
  }
}

// R registers a thread, G warps a pair; a block folds kWarps / G pairs at once
template <int R, int G, bool kGathered>
__device__ __forceinline__ void dd_rows_body(const DdArgs& a) {
  constexpr int kWarps = G > kBlockWarps ? G : kBlockWarps;
  constexpr int kPairs = kWarps / G;
  constexpr int kSpan = 32 * G;
  extern __shared__ float qs[];                // [d] the block's query row
  __shared__ float xh[G > 1 ? kWarps * 32 : 1];  // the cross-warp levels (G > 1)
  __shared__ float xl[G > 1 ? kWarps * 32 : 1];
  __shared__ float xs[kWarps];                 // per-warp sabs (G > 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = warp / G, thread = tid - pair * kSpan;
  const int bi = blockIdx.x;
  const int j0 = blockIdx.y * a.slots_per_block;
  const int j1 = min(j0 + a.slots_per_block, a.t);

  float c[R];
  int j = j0 + pair;
  if (j < j1) load_row<kGathered>(a, bi, j, thread, kSpan, c);
  const float* qrow = a.q + (size_t)bi * a.d;
  for (int i = tid; i < a.d; i += kWarps * 32) qs[i] = qrow[i];
  __syncthreads();

  for (; j < j1; j += kPairs) {
    float h[R], l[R];
    float sabs = 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = thread + kSpan * i;
      h[i] = e < a.d ? __fmul_rn(qs[e], c[i]) : 0.0f;  // zero padding up to P
      l[i] = 0.0f;
      sabs = __fadd_rn(sabs, fabsf(h[i]));
    }
    if (j + kPairs < j1) load_row<kGathered>(a, bi, j + kPairs, thread, kSpan, c);  // next row in flight

    fold_registers<R / 2>(h, l);
    for (int o = 16; o > 0; o >>= 1) sabs = __fadd_rn(sabs, __shfl_xor_sync(0xffffffffu, sabs, o));

    float hh = h[0], ll = l[0];
    if constexpr (G > 1) {
      float* gh = xh + pair * kSpan;
      float* gl = xl + pair * kSpan;
      gh[thread] = hh;
      gl[thread] = ll;
      if (lane == 0) xs[warp] = sabs;
      pair_sync(1 + pair, kSpan);
      if (thread == 0) {
        sabs = 0.0f;
        for (int w = 0; w < G; ++w) sabs = __fadd_rn(sabs, xs[pair * G + w]);
      }
#pragma unroll
      for (int half = kSpan / 2; half >= 32; half >>= 1) {
        if (thread < half) {
          dd_fold(hh, ll, gh[thread + half], gl[thread + half]);
          gh[thread] = hh;
          gl[thread] = ll;
        }
        pair_sync(1 + pair, kSpan);
      }
    }
    if (thread < 32) {
#pragma unroll
      for (int half = 16; half >= 1; half >>= 1) {
        const float ph = __shfl_down_sync(0xffffffffu, hh, half);
        const float pl = __shfl_down_sync(0xffffffffu, ll, half);
        if (half < a.p && lane < half) dd_fold(hh, ll, ph, pl);
      }
      if (thread == 0) {
        const size_t o = (size_t)bi * a.t + j;
        a.hi[o] = hh;
        a.lo[o] = ll;
        a.sabs[o] = sabs;
      }
    }
  }
}

template <int R, int G>
__global__ void __launch_bounds__(32 * (G > kBlockWarps ? G : kBlockWarps))
    dd_rows_kernel(DdArgs a) {
  dd_rows_body<R, G, false>(a);
}

template <int R, int G>
__global__ void __launch_bounds__(32 * (G > kBlockWarps ? G : kBlockWarps))
    dd_rows_gathered_kernel(DdArgs a) {
  dd_rows_body<R, G, true>(a);
}

template <int R, int G, bool kGathered>
int launch(const DdArgs& a, int b, cudaStream_t stream) {
  constexpr int kWarps = G > kBlockWarps ? G : kBlockWarps;
  auto kernel = kGathered ? dd_rows_gathered_kernel<R, G> : dd_rows_kernel<R, G>;
  const size_t smem = (size_t)a.d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(b, (a.t + a.slots_per_block - 1) / a.slots_per_block);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kGathered>
int dispatch(DdArgs& a, int b, cudaStream_t s) {
  const int p = a.p;
  const int g = p > 1024 ? p / 1024 : 1;  // warps a pair
  a.slots_per_block = (g >= kBlockWarps ? 1 : kBlockWarps / g) * kSlotsPerWarp;
  switch (p) {
    case 1: case 2: case 4: case 8: case 16: case 32: return launch<1, 1, kGathered>(a, b, s);
    case 64: return launch<2, 1, kGathered>(a, b, s);
    case 128: return launch<4, 1, kGathered>(a, b, s);
    case 256: return launch<8, 1, kGathered>(a, b, s);
    case 512: return launch<16, 1, kGathered>(a, b, s);
    case 1024: return launch<32, 1, kGathered>(a, b, s);
    case 2048: return launch<32, 2, kGathered>(a, b, s);
    case 4096: return launch<32, 4, kGathered>(a, b, s);
    case 8192: return launch<32, 8, kGathered>(a, b, s);
    default: return launch<32, 16, kGathered>(a, b, s);
  }
}

int pad_of(int d) {
  int p = 1;
  while (p < d) p *= 2;
  return p;
}

}  // namespace

// raw f32[n, d], rows i32[b, t], q f32[b, d] -> hi, lo, sabs f32[b, t]
extern "C" int omni_dd_rows(const void* raw, const void* rows, const void* q, void* hi,
                            void* lo, void* sabs, int n, int d, int b, int t, void* stream) {
  if (n <= 0 || d <= 0 || b <= 0 || t <= 0) return -1;
  const int p = pad_of(d);
  if (p > kMaxPad) return -1;
  DdArgs a;
  a.raw = static_cast<const float*>(raw);
  a.rows = static_cast<const int32_t*>(rows);
  a.q = static_cast<const float*>(q);
  a.hi = static_cast<float*>(hi);
  a.lo = static_cast<float*>(lo);
  a.sabs = static_cast<float*>(sabs);
  a.n = n; a.d = d; a.t = t; a.p = p;
  return dispatch<false>(a, b, static_cast<cudaStream_t>(stream));
}

// c f32[b, t, d] (gathered rows), q f32[b, d] -> hi, lo, sabs f32[b, t]
extern "C" int omni_dd_rows_gathered(const void* c, const void* q, void* hi, void* lo,
                                     void* sabs, int d, int b, int t, void* stream) {
  if (d <= 0 || b <= 0 || t <= 0) return -1;
  const int p = pad_of(d);
  if (p > kMaxPad) return -1;
  DdArgs a;
  a.raw = static_cast<const float*>(c);
  a.rows = nullptr;
  a.q = static_cast<const float*>(q);
  a.hi = static_cast<float*>(hi);
  a.lo = static_cast<float*>(lo);
  a.sabs = static_cast<float*>(sabs);
  a.n = b * t; a.d = d; a.t = t; a.p = p;
  return dispatch<true>(a, b, static_cast<cudaStream_t>(stream));
}

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
