// Hand-written Hopper (sm_90a) kernels for the residual refine stage: K3, and below it T3
// (K3's body over pre-gathered slabs, the tool's launch).
//
// Replaces _make_refine_kernel_full of omni_recall_tpu/ops/refine.py (the TPU kernel
// launched by _refine_bounds_fused). For each (query b, candidate slot j) it reads the
// candidate row rows[b, j] straight from the index planes (rows < 0, and rows >= N,
// which no caller passes, read row 0 and are masked) and computes the refined sound
// upper bound
//
//   d_xy  = q_x . c_y  for x, y in {1, 2}      four exact int32 dot products (__dp4a)
//   kwd   = kw_w8 . bloom_bits(row)            exact int32 keyword dot
//   cos   = fma(s1, fma(t1, d11, t2*d21), s2*fma(t1, d12, t2*d22))
//   delta = fma(qn, ec2, eq2*(1 + ec2))
//   kw    = min(fma(kwd, 1/127, kw_b), 1)
//   add   = fma(0.1, rec, REFINE_EPS), or -1e30 for a sentinel slot, an invalid
//           row or a -inf scan bound
//   out   = fma(0.2, kw, 0.7*(cos + delta)) + add       (<= -0.5e30 -> -inf)
//
// in the f32 order of the TPU kernel as XLA's compiler contracts it (ops/refine.py says
// how that was established). Each block first quantizes its query exactly as
// refine.py quantize_queries_int8_residual does in PyTorch: absmax * fl32(1/127)
// scales, round-half-even of x / scale clamped to [-127, 127], residuals
// fma(-q, scale, x), and the sums of squares of qn and eq2 in row_sum's order (32-element
// blocks summed in sequence, then the block sums in sequence). Every f32 operation is
// written out with __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn / __fmaf_rn and the
// library builds with -fmad=false, so the result is bit-identical to
// refine_bounds_plain. Only the recency term rec = exp(min(created - now, 0) / 30)
// comes from outside (ops/refine.py recency_term, shared with the plain version).
//
// What bounds it on the H100: bytes. Each candidate needs its two int8 rows (2*d),
// its bloom row (W) and four sidecars: at d = 768, W = 128 about 1.68 kB, so the
// serving select stage (448 queries x 64 candidates, 48 MB) is bounded near 0.014 ms
// at 3.35 TB/s, and its ~3e7 int8 operations are negligible beside that. Design: a
// block takes one query and a tile of its candidates, quantizes the query into shared
// memory and holds the keyword weights there too (reordered word-major, as in
// scan.cu); a warp takes one candidate at a time, reads its rows with 16-byte vector
// loads straight from the planes (no [B*m, d] gather in device memory), reduces the
// five integer sums with shuffles (exact, so their order is free) and lane 0 writes
// out[b, j]: each query's own columns, not the TPU's [qg, ct] block diagonal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
// the Python constants, rounded to f32 from their double values as PyTorch does
constexpr float kCosW = (float)0.7;             // COSINE_WEIGHT
constexpr float kKwW = (float)0.2;              // KEYWORD_WEIGHT
constexpr float kRecW = (float)0.1;             // RECENCY_WEIGHT
constexpr float kRefineEps = (float)3e-5;       // REFINE_EPS
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kEqRel = (float)(1.0 + 1e-4);   // eq2 slack
constexpr float kEqAbs = (float)3e-7;
constexpr float kQnRel = (float)(1.0 + 1e-6);   // qn slack
constexpr float kNegInf = (float)-1e30;         // _NEG_INF
constexpr float kMaskBelow = (float)(-1e30 * 0.5);

// floats of the reduction scratch: the block sums of a norm, or one per warp;
// a multiple of 4 so the int8 planes after it stay 16-byte aligned
__host__ __device__ inline int red_len(int d) {
  const int r = d / 32 > kWarps ? d / 32 : kWarps;
  return (r + 3) / 4 * 4;
}

struct Args {
  const int8_t* emb1;
  const int8_t* emb2;
  const uint8_t* bloom;
  const float* scale1;
  const float* scale2;
  const float* err2;
  const bool* valid;
  const float* q;
  const int8_t* kw_w8;
  const float* kw_b;
  const int32_t* rows;
  const float* vals;
  const float* rec;
  float* out;
  int n, d, w, b, m, cand_per_block;
};

// four low bits of n -> four 0/1 bytes (bit i -> byte i)
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

__device__ __forceinline__ int dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max |x[i]| over the block (exact in any order); red holds kWarps floats
__device__ float block_absmax(const float* x, int d, float* red) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) v = fmaxf(v, fabsf(x[i]));
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

// one int8 plane of x in place: q8 = clamp(rint(x / safe), -127, 127) and
// x <- fma(-q8, scale, x), the residual; returns the scale absmax * fl32(1/127)
__device__ float quantize_plane(float* x, int8_t* q8, int d, float* red) {
  const float scale = __fmul_rn(block_absmax(x, d, red), kInv127);
  const float safe = scale > 0.0f ? scale : 1.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(x[i], safe)), -127.0f), 127.0f);
    q8[i] = (int8_t)(int)v;
    x[i] = __fmaf_rn(-v, scale, x[i]);
  }
  __syncthreads();
  return scale;
}

// sqrt(sum of x[i]^2) summed in row_sum's order: 32-element blocks each in
// sequence, then the block sums in sequence, then a trailing partial block
// element by element; red holds d / 32 floats
__device__ float block_norm(const float* x, int d, float* red) {
  const int nb = d / 32;
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    float acc = 0.0f;
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, __fmul_rn(x[32 * j + i], x[32 * j + i]));
    red[j] = acc;
  }
  __syncthreads();
  float total = 0.0f;
  for (int j = 0; j < nb; ++j) total = __fadd_rn(total, red[j]);
  for (int i = 32 * nb; i < d; ++i) total = __fadd_rn(total, __fmul_rn(x[i], x[i]));
  __syncthreads();
  return __fsqrt_rn(total);
}

__global__ void __launch_bounds__(kThreads) refine_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);          // [d] query, then its residuals
  float* red = xf + a.d;                               // [red_len(d)]
  int8_t* sq1 = reinterpret_cast<int8_t*>(red + red_len(a.d));
  int8_t* sq2 = sq1 + a.d;
  int8_t* skw = sq2 + a.d;  // [W][8]: byte w's bit k at skw[w * 8 + k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y;
  const float* qrow = a.q + (size_t)bi * a.d;
  for (int i = tid; i < a.d; i += kThreads) xf[i] = qrow[i];
  // JAX column j of the bit matrix is bit j / W of word j % W
  const int kk = 8 * a.w;
  for (int j = tid; j < kk; j += kThreads)
    skw[(j % a.w) * 8 + j / a.w] = a.kw_w8[(size_t)bi * kk + j];
  __syncthreads();

  // quantize_queries_int8_residual, then qn = |q| * fl32(1 + 1e-6)
  const float t1 = quantize_plane(xf, sq1, a.d, red);
  const float t2 = quantize_plane(xf, sq2, a.d, red);
  const float eq2 = __fmaf_rn(block_norm(xf, a.d, red), kEqRel, kEqAbs);
  for (int i = tid; i < a.d; i += kThreads) xf[i] = qrow[i];
  __syncthreads();
  const float qn = __fmul_rn(block_norm(xf, a.d, red), kQnRel);
  const float kwb = a.kw_b[bi];

  const int4* q1v = reinterpret_cast<const int4*>(sq1);
  const int4* q2v = reinterpret_cast<const int4*>(sq2);
  const int dv = a.d / 16;
  const int j0 = blockIdx.x * a.cand_per_block;
  const int j1 = min(j0 + a.cand_per_block, a.m);
  for (int j = j0 + warp; j < j1; j += kWarps) {
    const size_t o = (size_t)bi * a.m + j;
    const int slot_row = a.rows[o];
    const int row = (slot_row < 0 || slot_row >= a.n) ? 0 : slot_row;
    const int4* e1 = reinterpret_cast<const int4*>(a.emb1 + (size_t)row * a.d);
    const int4* e2 = reinterpret_cast<const int4*>(a.emb2 + (size_t)row * a.d);
    int d11 = 0, d12 = 0, d21 = 0, d22 = 0, kwd = 0;
    for (int k = lane; k < dv; k += 32) {
      const int4 x1 = e1[k], x2 = e2[k], y1 = q1v[k], y2 = q2v[k];
      d11 = dot16(y1, x1, d11);
      d12 = dot16(y1, x2, d12);
      d21 = dot16(y2, x1, d21);
      d22 = dot16(y2, x2, d22);
    }
    const uint8_t* bl = a.bloom + (size_t)row * a.w;
    for (int wd = lane; wd < a.w; wd += 32) {
      const uint32_t byte = bl[wd];
      const int* kw2 = reinterpret_cast<const int*>(skw + wd * 8);
      kwd = __dp4a((int)expand4(byte & 15u), kw2[0], kwd);
      kwd = __dp4a((int)expand4(byte >> 4), kw2[1], kwd);
    }
    d11 = warp_sum(d11);
    d12 = warp_sum(d12);
    d21 = warp_sum(d21);
    d22 = warp_sum(d22);
    kwd = warp_sum(kwd);
    if (lane == 0) {
      const float s1 = a.scale1[row], s2 = a.scale2[row], ec2 = a.err2[row];
      const bool live = slot_row >= 0 && a.valid[row] && a.vals[o] > __int_as_float(0xff800000);
      const float add = live ? __fmaf_rn(kRecW, a.rec[o], kRefineEps) : kNegInf;
      const float pa = __fmaf_rn(t1, (float)d11, __fmul_rn(t2, (float)d21));
      const float pb = __fmaf_rn(t1, (float)d12, __fmul_rn(t2, (float)d22));
      const float cos = __fmaf_rn(s1, pa, __fmul_rn(s2, pb));
      const float delta = __fmaf_rn(qn, ec2, __fmul_rn(eq2, __fadd_rn(1.0f, ec2)));
      const float kw = fminf(__fmaf_rn((float)kwd, kInv127, kwb), 1.0f);
      const float r =
          __fadd_rn(__fmaf_rn(kKwW, kw, __fmul_rn(kCosW, __fadd_rn(cos, delta))), add);
      a.out[o] = r <= kMaskBelow ? __int_as_float(0xff800000) : r;
    }
  }
}

// ---- T3: K3's body over pre-gathered slabs (tools/probe_serve.py:210) ----
//
// Replaces the tool's launch of _make_refine_kernel_full (k_body, tools/probe_serve.py
// :202-233). Its grid step k takes the ct = qg * m slab rows [k * ct, (k + 1) * ct) and
// the qg queries [k * qg, (k + 1) * qg) and writes the whole [qg, ct] tile:
//
//   out[k * qg + g, j] = fma(0.2, kw, 0.7 * (cos + delta)) + add[k * ct + j]
//
// with cos, delta and kw as in refine_kernel above (the same contractions: the tool's
// body is K3's, and tests/test_torch_probe_serve.py holds them against the tool's launch
// in interpret mode), over pre-quantized queries q1, q2 with t1, t2, eq2, qn passed in and
// the slab sidecars s1, s2, ec2, add passed in. No masking, no query quantization, no
// recency inside: those are the caller's, as in the tool. Every query of a tile is dotted
// against every slab row of the tile: qg times K3's dot products, the off-diagonal ones
// included, which the TPU paid for to fill its 128-lane tiles.
//
// What bounds it on the H100: bytes. Each slab row is 2 * d + W bytes plus four f32
// sidecars (1.68 kB at d = 768, W = 128) and is read once; the [B, ct] f32 output is
// written once. At the tool's shape (B = 1536, m = 128, qg 16) that is ~347 MB, 0.104 ms
// at 3.35 TB/s, against 2.6e10 int8 operations (0.013 ms at the int8 peak). Design: a
// block takes one tile's qg queries (both int8 planes and the keyword weights, reordered
// word-major as in refine_kernel: 40 KB at qg 16) into shared memory and a run of the
// tile's slab rows; eight lanes share a slab row, each reading 16-byte chunks of it once
// and scoring them against all qg queries with __dp4a into 5 * kSlabQg register sums,
// which three xor shuffles reduce over the eight lanes (exact integers, so the order is
// free). Lane g % 8 of the row's group combines and writes column j of query g. A
// separate kernel with its own argument block, so that refine_kernel's register
// allocation stays as it was. This is the simple version: its card time beside the
// bound is in PERF.md, and a tensor-core version is later work.

constexpr int kSlabQg = 16;                     // most queries a tile holds (the tool's min(16, .))
constexpr int kSlabLanes = 8;                   // lanes that share one slab row
constexpr int kSlabGroups = kThreads / kSlabLanes;  // slab rows a block scores at once
constexpr int kSlabRowsPerBlock = 2 * kSlabGroups;

struct SlabArgs {
  const int8_t* q1;
  const int8_t* q2;
  const float* t1;
  const float* t2;
  const float* eq2;
  const float* qn;
  const float* kwb;
  const int8_t* kw_w8;
  const int8_t* c1;
  const int8_t* c2;
  const uint8_t* bloom;
  const float* s1;
  const float* s2;
  const float* ec2;
  const float* add;
  float* out;
  int d, w, qg, ct;
};

__global__ void __launch_bounds__(kThreads) refine_slab_kernel(SlabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sq1 = reinterpret_cast<int8_t*>(smem);   // [qg][d]
  int8_t* sq2 = sq1 + a.qg * a.d;                  // [qg][d]
  int8_t* skw = sq2 + a.qg * a.d;                  // [qg][W][8]
  __shared__ float sterm[5][kSlabQg];              // t1, t2, eq2, qn, kwb of each query

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * a.qg;
  const int kk = 8 * a.w;
  {
    const int4* g1 = reinterpret_cast<const int4*>(a.q1 + (size_t)q0 * a.d);
    const int4* g2 = reinterpret_cast<const int4*>(a.q2 + (size_t)q0 * a.d);
    int4* d1 = reinterpret_cast<int4*>(sq1);
    int4* d2 = reinterpret_cast<int4*>(sq2);
    for (int i = tid; i < a.qg * a.d / 16; i += kThreads) {
      d1[i] = g1[i];
      d2[i] = g2[i];
    }
    // JAX column j of the bit matrix is bit j / W of word j % W: word wd's eight
    // weights (columns b * W + wd) go to skw[wd * 8 + b] in one 8-byte store
    const int8_t* kw = a.kw_w8 + (size_t)q0 * kk;
    for (int i = tid; i < a.qg * a.w; i += kThreads) {
      const int g = i / a.w, wd = i - g * a.w;
      const uint8_t* col = reinterpret_cast<const uint8_t*>(kw + (size_t)g * kk + wd);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        lo |= (uint32_t)col[b * a.w] << (8 * b);
        hi |= (uint32_t)col[(b + 4) * a.w] << (8 * b);
      }
      reinterpret_cast<uint2*>(skw + g * kk)[wd] = make_uint2(lo, hi);
    }
    if (tid < a.qg) {
      sterm[0][tid] = a.t1[q0 + tid];
      sterm[1][tid] = a.t2[q0 + tid];
      sterm[2][tid] = a.eq2[q0 + tid];
      sterm[3][tid] = a.qn[q0 + tid];
      sterm[4][tid] = a.kwb[q0 + tid];
    }
  }
  __syncthreads();

  const int part = tid % kSlabLanes;   // this lane's share of its row
  const int group = tid / kSlabLanes;  // the row group within the block
  const int dv = a.d / 16;
  const int j0 = blockIdx.x * kSlabRowsPerBlock;
  const int j1 = min(j0 + kSlabRowsPerBlock, a.ct);
  // every thread takes the same trips (the shuffles need whole warps); a group past the
  // tile's end scores the block's first row again and writes nothing
  for (int jb = j0; jb < j1; jb += kSlabGroups) {
    const int j = jb + group;
    const bool live = j < j1;
    const size_t row = (size_t)blockIdx.y * a.ct + (live ? j : j0);
    int acc[kSlabQg][5];
#pragma unroll
    for (int g = 0; g < kSlabQg; ++g)
#pragma unroll
      for (int v = 0; v < 5; ++v) acc[g][v] = 0;

    const int4* r1 = reinterpret_cast<const int4*>(a.c1 + row * a.d);
    const int4* r2 = reinterpret_cast<const int4*>(a.c2 + row * a.d);
    for (int k = part; k < dv; k += kSlabLanes) {
      const int4 x1 = r1[k], x2 = r2[k];
#pragma unroll
      for (int g = 0; g < kSlabQg; ++g) {
        if (g < a.qg) {
          const int4 y1 = reinterpret_cast<const int4*>(sq1 + g * a.d)[k];
          const int4 y2 = reinterpret_cast<const int4*>(sq2 + g * a.d)[k];
          acc[g][0] = dot16(y1, x1, acc[g][0]);  // d11
          acc[g][1] = dot16(y1, x2, acc[g][1]);  // d12
          acc[g][2] = dot16(y2, x1, acc[g][2]);  // d21
          acc[g][3] = dot16(y2, x2, acc[g][3]);  // d22
        }
      }
    }
    const uint8_t* bl = a.bloom + row * a.w;
    for (int wd = part; wd < a.w; wd += kSlabLanes) {
      const uint32_t byte = bl[wd];
      const int lo = (int)expand4(byte & 15u), hi = (int)expand4(byte >> 4);
#pragma unroll
      for (int g = 0; g < kSlabQg; ++g) {
        if (g < a.qg) {
          const int* kw2 = reinterpret_cast<const int*>(skw + g * kk + wd * 8);
          acc[g][4] = __dp4a(lo, kw2[0], acc[g][4]);
          acc[g][4] = __dp4a(hi, kw2[1], acc[g][4]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kSlabQg; ++g) {
      if (g < a.qg) {
#pragma unroll
        for (int v = 0; v < 5; ++v)
#pragma unroll
          for (int o = kSlabLanes / 2; o > 0; o >>= 1)
            acc[g][v] += __shfl_xor_sync(0xffffffffu, acc[g][v], o);
      }
    }
    if (live) {
      const float s1 = a.s1[row], s2 = a.s2[row], ec2 = a.ec2[row], add = a.add[row];
      const float ec2p1 = __fadd_rn(1.0f, ec2);
#pragma unroll
      for (int g = 0; g < kSlabQg; ++g) {
        if (g < a.qg && g % kSlabLanes == part) {
          const float t1 = sterm[0][g], t2 = sterm[1][g];
          const float pa = __fmaf_rn(t1, (float)acc[g][0], __fmul_rn(t2, (float)acc[g][2]));
          const float pb = __fmaf_rn(t1, (float)acc[g][1], __fmul_rn(t2, (float)acc[g][3]));
          const float cos = __fmaf_rn(s1, pa, __fmul_rn(s2, pb));
          const float delta = __fmaf_rn(sterm[3][g], ec2, __fmul_rn(sterm[2][g], ec2p1));
          const float kw = fminf(__fmaf_rn((float)acc[g][4], kInv127, sterm[4][g]), 1.0f);
          a.out[(size_t)(q0 + g) * a.ct + j] =
              __fadd_rn(__fmaf_rn(kKwW, kw, __fmul_rn(kCosW, __fadd_rn(cos, delta))), add);
        }
      }
    }
  }
}

}  // namespace

// emb1/emb2 i8[n, d], bloom u8[n, w], scale1/scale2/err2 f32[n], valid bool[n],
// q f32[b, d], kw_w8 i8[b, 8w], kw_b f32[b], rows i32[b, m], vals/rec f32[b, m]
// -> out f32[b, m]
extern "C" int omni_refine(const void* emb1, const void* emb2, const void* bloom,
                           const void* scale1, const void* scale2, const void* err2,
                           const void* valid, const void* q, const void* kw_w8, const void* kw_b,
                           const void* rows, const void* vals, const void* rec, void* out,
                           int n, int d, int w, int b, int m, void* stream) {
  if (n <= 0 || d <= 0 || d % 16 != 0 || w <= 0 || b <= 0 || m <= 0 || b > 65535) return -1;
  const size_t smem = (size_t)4 * (d + red_len(d)) + (size_t)2 * d + (size_t)8 * w;
  if (smem > (size_t)kMaxSmem) return -1;
  Args a;
  a.emb1 = static_cast<const int8_t*>(emb1);
  a.emb2 = static_cast<const int8_t*>(emb2);
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.scale1 = static_cast<const float*>(scale1);
  a.scale2 = static_cast<const float*>(scale2);
  a.err2 = static_cast<const float*>(err2);
  a.valid = static_cast<const bool*>(valid);
  a.q = static_cast<const float*>(q);
  a.kw_w8 = static_cast<const int8_t*>(kw_w8);
  a.kw_b = static_cast<const float*>(kw_b);
  a.rows = static_cast<const int32_t*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.rec = static_cast<const float*>(rec);
  a.out = static_cast<float*>(out);
  a.n = n; a.d = d; a.w = w; a.b = b; a.m = m;
  // 64 candidates per block, more at the rescue widths so each query is
  // quantized by at most ~8 blocks
  a.cand_per_block = 64 * ((m + 511) / 512);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(refine_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + a.cand_per_block - 1) / a.cand_per_block, b);
  refine_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// T3. q1/q2 i8[b, d], t1/t2/eq2/qn/kwb f32[b], kw_w8 i8[b, 8w], c1/c2 i8[b*m, d],
// bloom u8[b*m, w], s1/s2/ec2/add f32[b*m] -> out f32[b, qg*m]; b % qg == 0
extern "C" int omni_refine_slab(const void* q1, const void* q2, const void* t1, const void* t2,
                                const void* eq2, const void* qn, const void* kwb,
                                const void* kw_w8, const void* c1, const void* c2,
                                const void* bloom, const void* s1, const void* s2,
                                const void* ec2, const void* add, void* out, int b, int d,
                                int w, int m, int qg, void* stream) {
  if (b <= 0 || d <= 0 || d % 16 != 0 || w <= 0 || m <= 0 || qg < 1 || qg > kSlabQg ||
      b % qg != 0 || b / qg > 65535)
    return -1;
  const size_t smem = (size_t)qg * (2 * d + 8 * w);
  if (smem > (size_t)kMaxSmem) return -1;
  SlabArgs a;
  a.q1 = static_cast<const int8_t*>(q1);
  a.q2 = static_cast<const int8_t*>(q2);
  a.t1 = static_cast<const float*>(t1);
  a.t2 = static_cast<const float*>(t2);
  a.eq2 = static_cast<const float*>(eq2);
  a.qn = static_cast<const float*>(qn);
  a.kwb = static_cast<const float*>(kwb);
  a.kw_w8 = static_cast<const int8_t*>(kw_w8);
  a.c1 = static_cast<const int8_t*>(c1);
  a.c2 = static_cast<const int8_t*>(c2);
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.s1 = static_cast<const float*>(s1);
  a.s2 = static_cast<const float*>(s2);
  a.ec2 = static_cast<const float*>(ec2);
  a.add = static_cast<const float*>(add);
  a.out = static_cast<float*>(out);
  a.d = d; a.w = w; a.qg = qg; a.ct = qg * m;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(refine_slab_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a.ct + kSlabRowsPerBlock - 1) / kSlabRowsPerBlock, b / qg);
  refine_slab_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
