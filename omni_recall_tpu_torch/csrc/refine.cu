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
//   rec   = exp(min(created - now, 0) * fl32(1/30))
//   add   = fma(0.1, rec, REFINE_EPS), or -1e30 for a sentinel slot, an invalid
//           row or a -inf scan bound
//   out   = fma(0.2, kw, 0.7*(cos + delta)) + add       (<= -0.5e30 -> -inf)
//
// in the f32 order of the TPU kernel as XLA's compiler contracts it (ops/refine.py says
// how that was established). The query is quantized exactly as refine.py
// quantize_queries_int8_residual does in PyTorch: absmax * fl32(1/127) scales,
// round-half-even of x / scale clamped to [-127, 127], residuals fma(-q, scale, x), and
// the sums of squares of qn and eq2 in row_sum's order (32-element blocks summed in
// sequence, then the block sums in sequence, then a trailing partial block element by
// element). Every f32 operation is written out with __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn / __fmaf_rn and the library builds with -fmad=false; rec is the CUDA math
// library's expf, which gives torch.exp's bits on every f32 argument <= 0, the term's whole
// domain (chip_smoke.py checks each of them, and the term itself over whole indexes). So out
// is bit-identical to refine_bounds_plain on the card.
//
// What bounds it on the H100: bytes. Each candidate needs its two int8 rows (2*d), its
// bloom row (W) and five sidecars: at d = 768, W = 128 about 1.68 kB, so the serving
// select stage (448 queries x 64 candidates, 48 MB) is bounded near 0.015 ms at 3.35
// TB/s and the rescue stage (64 x 2048) near 0.062 ms; their int8 operations (~4 a
// byte) are negligible beside that. The levers are bytes in flight and no stalls:
// - Eight lanes share a candidate, four candidates a warp. Each lane issues its 16-byte
//   loads of both planes (six each at d = 768), its 16 bloom bytes and one sidecar (the
//   two scales, err2, valid, the scan bound, created) at once: ~6.7 kB in flight a warp.
//   The next four candidates' loads go out before this four's reductions and combine.
// - Warp 0 quantizes the block's query alone, in shared memory padded by one float a
//   32-element block (conflict-free by element and by block), with shuffles and
//   __syncwarp only, while the other warps reorder the keyword weights; every warp's
//   first loads are in flight before the one barrier that hands the query over. Its
//   loads go out eight at a time, and it divides only next to rounding ties (warp_plane),
//   so that it does not wait on each load and each division in turn.
// - Blocks of four warps (128 registers, four blocks an SM), so that one block's
//   prologue overlaps three others' gathers. A block takes one query and a tile of its
//   candidates, cut only as far as filling the card needs (three blocks an SM): at
//   [64, 2048] a query is quantized by seven blocks, at [448, 64] by one.
// - The eight lanes' sums meet in three xor shuffles (exact integers, so the order is
//   free) and lane 0 of the eight combines and writes out[b, j]: each query's own
//   columns, not the TPU's [qg, ct] block diagonal.
// rows and vals are read with a row stride, so the engine passes its [B, m + 1] scan
// output as it lies.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // recency_kernel's block
constexpr int kMaxSmem = 232448;
// the Python constants, rounded to f32 from their double values as PyTorch does
constexpr float kCosW = (float)0.7;             // COSINE_WEIGHT
constexpr float kKwW = (float)0.2;              // KEYWORD_WEIGHT
constexpr float kRecW = (float)0.1;             // RECENCY_WEIGHT
constexpr float kRefineEps = (float)3e-5;       // REFINE_EPS
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kInvHalfLife = (float)(1.0 / 30.0);  // 1 / RECENCY_HALF_LIFE_DAYS
constexpr float kEqRel = (float)(1.0 + 1e-4);   // eq2 slack
constexpr float kEqAbs = (float)3e-7;
constexpr float kQnRel = (float)(1.0 + 1e-6);   // qn slack
constexpr float kNegInf = (float)-1e30;         // _NEG_INF
constexpr float kMaskBelow = (float)(-1e30 * 0.5);
constexpr float kTie = 1.0f / 1024;             // see warp_plane

constexpr int kWarps = 4;                       // K3's block: 4 warps
constexpr int kCandLanes = 8;                   // lanes that share one candidate
constexpr int kCandsPerWarp = 32 / kCandLanes;  // candidates a warp takes at once
constexpr int kStep = kWarps * kCandsPerWarp;   // candidates a block takes at once
constexpr int kPlaneAhead = 6;  // 16-byte chunks of each plane a lane loads ahead: d <= 768
constexpr int kBlocksPerSm = 3;  // the blocks a launch aims for, when tiles must be cut

struct Args {
  const int8_t* emb1;
  const int8_t* emb2;
  const uint8_t* bloom;
  const float* scale1;
  const float* scale2;
  const float* err2;
  const bool* valid;
  const float* created;
  const float* q;
  const int8_t* kw_w8;
  const float* kw_b;
  const int32_t* rows;
  const float* vals;
  float* out;
  float now;
  int n, d, w, m, rows_stride, vals_stride, cand_per_block;
};

// The dynamic shared memory of refine_kernel: the int8 query planes sq1, sq2 [d]; the
// keyword weights, word wd's eight (bit k at byte k) at kw_offset(wd), eight bytes of
// padding after each 16 words so that eight lanes on 16 words each meet no conflict;
// then the f32 query [pad32(d)], element i at pad32(i), one float of padding a
// 32-element block; then its d / 32 block sums.
__host__ __device__ inline int kw_offset(int wd) { return 8 * wd + 8 * (wd >> 4); }
__host__ __device__ inline int pad32(int i) { return i + (i >> 5); }
__host__ __device__ inline size_t query_offset(int d, int w) {
  return ((size_t)2 * d + kw_offset(w) + 15) / 16 * 16;
}
__host__ __device__ inline size_t refine_smem(int d, int w) {
  return query_offset(d, w) + sizeof(float) * ((size_t)pad32(d) + d / 32);
}

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sqrt of the sum of the squares of the padded x[0, d) in row_sum's order: lane j sums
// block j's 32 elements in sequence, lane 0 the block sums in sequence and then a
// trailing partial block element by element
__device__ float warp_norm(const float* xs, float* red, int d, int lane) {
  const int nb = d >> 5;
  for (int j = lane; j < nb; j += 32) {
    const float* blk = xs + 33 * j;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, __fmul_rn(blk[i], blk[i]));
    red[j] = acc;
  }
  __syncwarp();
  float total = 0.0f;
  if (lane == 0) {
#pragma unroll 8
    for (int j = 0; j < nb; ++j) total = __fadd_rn(total, red[j]);
    for (int e = nb << 5; e < d; ++e) {
      const float x = xs[pad32(e)];
      total = __fadd_rn(total, __fmul_rn(x, x));
    }
  }
  total = __shfl_sync(0xffffffffu, total, 0);
  __syncwarp();
  return __fsqrt_rn(total);
}

// one int8 plane of the padded x in place: q8 = clamp(rint(x / safe), -127, 127) and
// x <- fma(-q8, scale, x), the residual; takes x's absmax, returns the scale
// absmax * fl32(1/127) and leaves the residual's absmax in absmax. The quotient is taken
// as x * fl32(1/safe), within 2e-5 of x / safe and of its rounding (|x / safe| <= 127.01),
// so the two round to the same integer unless the product lies within kTie of a tie
// k + 1/2 (or is not finite): there x / safe is divided exactly.
__device__ float warp_plane(float* xs, int8_t* q8, int d, float& absmax, int lane) {
  constexpr int kElems = 8;  // elements a lane takes at once
  const float scale = __fmul_rn(absmax, kInv127);
  const float safe = scale > 0.0f ? scale : 1.0f;
  const float inv = __frcp_rn(safe);
  float next = 0.0f;
  for (int e0 = lane; e0 < d; e0 += 32 * kElems) {
    float x[kElems], v[kElems];
    unsigned near = 0;
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int e = e0 + 32 * k;
      x[k] = e < d ? xs[pad32(e)] : 0.0f;
      const float qa = __fmul_rn(x[k], inv);
      v[k] = rintf(qa);
      const float tie = fabsf(__fsub_rn(__fsub_rn(qa, floorf(qa)), 0.5f));
      if (!(tie >= kTie && fabsf(qa) <= 128.0f)) near |= 1u << k;
    }
    if (near) {
#pragma unroll
      for (int k = 0; k < kElems; ++k)
        if ((near >> k) & 1u) v[k] = rintf(__fdiv_rn(x[k], safe));
    }
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int e = e0 + 32 * k;
      if (e < d) {
        const float vc = fminf(fmaxf(v[k], -127.0f), 127.0f);
        q8[e] = (int8_t)(int)vc;
        const float r = __fmaf_rn(-vc, scale, x[k]);
        xs[pad32(e)] = r;
        next = fmaxf(next, fabsf(r));
      }
    }
  }
  absmax = warp_max(next);
  __syncwarp();
  return scale;
}

// quantize_queries_int8_residual and qn = |q| * fl32(1 + 1e-6), by one warp:
// qterm <- t1, t2, eq2, qn
__device__ void quantize_query(const float* qrow, int d, float* xs, float* red, int8_t* sq1,
                               int8_t* sq2, float* qterm, int lane) {
  // four floats a lane at a time, eight loads in flight before the first store
  constexpr int kLoads = 8;
  float absmax = 0.0f;
  for (int e0 = 4 * lane; e0 < d; e0 += 128 * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int e = e0 + 128 * k;
      v[k] = e < d ? __ldg(reinterpret_cast<const float4*>(qrow + e)) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int e = e0 + 128 * k;
      if (e < d) {  // e % 4 == 0: the four share a 32-element block
        float* x = xs + pad32(e);
        x[0] = v[k].x;
        x[1] = v[k].y;
        x[2] = v[k].z;
        x[3] = v[k].w;
        absmax = fmaxf(absmax, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)),
                                     fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
      }
    }
  }
  absmax = warp_max(absmax);
  __syncwarp();
  const float qn = __fmul_rn(warp_norm(xs, red, d, lane), kQnRel);
  const float t1 = warp_plane(xs, sq1, d, absmax, lane);
  const float t2 = warp_plane(xs, sq2, d, absmax, lane);
  const float eq2 = __fmaf_rn(warp_norm(xs, red, d, lane), kEqRel, kEqAbs);
  if (lane == 0) {
    qterm[0] = t1;
    qterm[1] = t2;
    qterm[2] = eq2;
    qterm[3] = qn;
  }
}

// the recency term's exp: the CUDA math library's expf, used on the condition that it gives
// torch.exp's bits on every argument the term can take (every f32 <= 0)
__device__ __forceinline__ float recency_exp(float x) { return expf(x); }

// the recency term of a row created on day `created`: exp(min(created - now, 0) / 30), with
// the division as XLA's jit writes it, a multiply by fl32(1/30)
__device__ __forceinline__ float recency(float created, float now) {
  return recency_exp(__fmul_rn(fminf(__fsub_rn(created, now), 0.0f), kInvHalfLife));
}

// K3's recency term of every row alone (or, with exp_only, its exp of every argument given),
// so that it can be held to torch.exp's bits
__global__ void recency_kernel(const float* __restrict__ created, float* __restrict__ out,
                               float now, int n, bool exp_only) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = exp_only ? recency_exp(created[i]) : recency(created[i], now);
}

// what one lane holds of its candidate between the loads and the dots
struct Cand {
  int slot_row;  // rows[b, j] as given
  int row;       // the row read
  float side;    // this lane's sidecar: scale1, scale2, err2, valid, vals[b, j], created
  int4 e1[kPlaneAhead];
  int4 e2[kPlaneAhead];
  int4 bl;       // bloom bytes [16 * part, 16 * part + 16) when W % 16 == 0
};

__device__ __forceinline__ void load_cand(const Args& a, int bi, int j, int part,
                                          bool vec_bloom, Cand& c) {
  c.slot_row = __ldg(a.rows + (size_t)bi * a.rows_stride + j);
  c.row = (c.slot_row < 0 || c.slot_row >= a.n) ? 0 : c.slot_row;
  const size_t r = c.row;
  const float* side = part == 0   ? a.scale1 + r
                      : part == 1 ? a.scale2 + r
                      : part == 2 ? a.err2 + r
                      : part == 4 ? a.vals + (size_t)bi * a.vals_stride + j
                                  : a.created + r;
  c.side = part == 3 ? (a.valid[r] ? 1.0f : 0.0f) : part < 6 ? __ldg(side) : 0.0f;
  const int4* p1 = reinterpret_cast<const int4*>(a.emb1 + r * a.d);
  const int4* p2 = reinterpret_cast<const int4*>(a.emb2 + r * a.d);
  const int dv = a.d >> 4;
#pragma unroll
  for (int u = 0; u < kPlaneAhead; ++u) {
    const int k = part + kCandLanes * u;
    c.e1[u] = k < dv ? __ldg(p1 + k) : make_int4(0, 0, 0, 0);
    c.e2[u] = k < dv ? __ldg(p2 + k) : make_int4(0, 0, 0, 0);
  }
  c.bl = vec_bloom && part < (a.w >> 4)
             ? __ldg(reinterpret_cast<const int4*>(a.bloom + r * a.w) + part)
             : make_int4(0, 0, 0, 0);
}

// the keyword dot of one bloom byte (word wd) against its eight weights
__device__ __forceinline__ int kw_byte(uint32_t byte, int wd, const uint8_t* skw, int acc) {
  const uint2 k = *reinterpret_cast<const uint2*>(skw + kw_offset(wd));
  acc = __dp4a((int)expand4(byte & 15u), (int)k.x, acc);
  return __dp4a((int)expand4(byte >> 4), (int)k.y, acc);
}

// sixteen bloom bytes, words [16 * chunk, 16 * chunk + 16)
__device__ __forceinline__ int kw_chunk(int4 v, int chunk, const uint8_t* skw, int acc) {
  const uint32_t words[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    acc = kw_byte((words[i >> 2] >> (8 * (i & 3))) & 255u, 16 * chunk + i, skw, acc);
  return acc;
}

// this lane's share of the five integer sums d11, d12, d21, d22, kwd
__device__ __forceinline__ void cand_dots(const Args& a, const Cand& c, int part,
                                          const int4* q1v, const int4* q2v,
                                          const uint8_t* skw, bool vec_bloom, int (&acc)[5]) {
  const int dv = a.d >> 4;
#pragma unroll
  for (int u = 0; u < kPlaneAhead; ++u) {
    const int k = part + kCandLanes * u;
    if (k < dv) {
      const int4 y1 = q1v[k], y2 = q2v[k];
      acc[0] = dot16(y1, c.e1[u], acc[0]);
      acc[1] = dot16(y1, c.e2[u], acc[1]);
      acc[2] = dot16(y2, c.e1[u], acc[2]);
      acc[3] = dot16(y2, c.e2[u], acc[3]);
    }
  }
  // the rest of a row wider than the loads ahead
  const size_t r = c.row;
  const int4* p1 = reinterpret_cast<const int4*>(a.emb1 + r * a.d);
  const int4* p2 = reinterpret_cast<const int4*>(a.emb2 + r * a.d);
  for (int k = part + kCandLanes * kPlaneAhead; k < dv; k += kCandLanes) {
    const int4 x1 = __ldg(p1 + k), x2 = __ldg(p2 + k), y1 = q1v[k], y2 = q2v[k];
    acc[0] = dot16(y1, x1, acc[0]);
    acc[1] = dot16(y1, x2, acc[1]);
    acc[2] = dot16(y2, x1, acc[2]);
    acc[3] = dot16(y2, x2, acc[3]);
  }
  const uint8_t* bl = a.bloom + r * a.w;
  if (vec_bloom) {
    const int chunks = a.w >> 4;
    if (part < chunks) acc[4] = kw_chunk(c.bl, part, skw, acc[4]);
    for (int k = part + kCandLanes; k < chunks; k += kCandLanes)
      acc[4] = kw_chunk(__ldg(reinterpret_cast<const int4*>(bl) + k), k, skw, acc[4]);
  } else {
    for (int wd = part; wd < a.w; wd += kCandLanes) acc[4] = kw_byte(bl[wd], wd, skw, acc[4]);
  }
}

__global__ void __launch_bounds__(32 * kWarps, 4) refine_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sq1 = reinterpret_cast<int8_t*>(smem);
  int8_t* sq2 = sq1 + a.d;
  uint8_t* skw = reinterpret_cast<uint8_t*>(sq2 + a.d);
  float* xs = reinterpret_cast<float*>(smem + query_offset(a.d, a.w));
  float* red = xs + pad32(a.d);
  __shared__ float qterm[5];  // t1, t2, eq2, qn, kw_b

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = lane % kCandLanes, lead = lane - part, slot = lane / kCandLanes;
  const int bi = blockIdx.y;
  const bool vec_bloom = (a.w & 15) == 0;
  const int j0 = blockIdx.x * a.cand_per_block;
  const int j1 = min(j0 + a.cand_per_block, a.m);
  // lanes past the tile's end load its last candidate again and write nothing
  int jw = j0 + warp * kCandsPerWarp;
  Cand c;
  if (jw < j1) load_cand(a, bi, min(jw + slot, j1 - 1), part, vec_bloom, c);

  if (warp == 0) {
    quantize_query(a.q + (size_t)bi * a.d, a.d, xs, red, sq1, sq2, qterm, lane);
  } else {
    // JAX column j of the bit matrix is bit j / W of word j % W: word wd's eight
    // weights (columns k * W + wd) go to kw_offset(wd) in one 8-byte store
    const uint8_t* kw = reinterpret_cast<const uint8_t*>(a.kw_w8) + (size_t)bi * 8 * a.w;
    for (int wd = tid - 32; wd < a.w; wd += 32 * kWarps - 32) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo |= (uint32_t)kw[k * a.w + wd] << (8 * k);
        hi |= (uint32_t)kw[(k + 4) * a.w + wd] << (8 * k);
      }
      *reinterpret_cast<uint2*>(skw + kw_offset(wd)) = make_uint2(lo, hi);
    }
    if (tid == 32) qterm[4] = a.kw_b[bi];
  }
  __syncthreads();

  const float t1 = qterm[0], t2 = qterm[1], eq2 = qterm[2], qn = qterm[3], kwb = qterm[4];
  const int4* q1v = reinterpret_cast<const int4*>(sq1);
  const int4* q2v = reinterpret_cast<const int4*>(sq2);
  for (; jw < j1; jw += kStep) {
    const int j = jw + slot;
    int acc[5] = {0, 0, 0, 0, 0};
    cand_dots(a, c, part, q1v, q2v, skw, vec_bloom, acc);
    const float s1 = __shfl_sync(0xffffffffu, c.side, lead);
    const float s2 = __shfl_sync(0xffffffffu, c.side, lead + 1);
    const float ec2 = __shfl_sync(0xffffffffu, c.side, lead + 2);
    const float valid = __shfl_sync(0xffffffffu, c.side, lead + 3);
    const float val = __shfl_sync(0xffffffffu, c.side, lead + 4);
    const float created = __shfl_sync(0xffffffffu, c.side, lead + 5);
    const int slot_row = c.slot_row;
    if (jw + kStep < j1) load_cand(a, bi, min(jw + kStep + slot, j1 - 1), part, vec_bloom, c);
#pragma unroll
    for (int v = 0; v < 5; ++v)
#pragma unroll
      for (int o = kCandLanes / 2; o > 0; o >>= 1)
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
    if (part == 0 && j < j1) {
      const bool live = slot_row >= 0 && valid != 0.0f && val > __int_as_float(0xff800000);
      const float add = live ? __fmaf_rn(kRecW, recency(created, a.now), kRefineEps) : kNegInf;
      const float pa = __fmaf_rn(t1, (float)acc[0], __fmul_rn(t2, (float)acc[2]));
      const float pb = __fmaf_rn(t1, (float)acc[1], __fmul_rn(t2, (float)acc[3]));
      const float cos = __fmaf_rn(s1, pa, __fmul_rn(s2, pb));
      const float delta = __fmaf_rn(qn, ec2, __fmul_rn(eq2, __fadd_rn(1.0f, ec2)));
      const float kw = fminf(__fmaf_rn((float)acc[4], kInv127, kwb), 1.0f);
      const float r =
          __fadd_rn(__fmaf_rn(kKwW, kw, __fmul_rn(kCosW, __fadd_rn(cos, delta))), add);
      a.out[(size_t)bi * a.m + j] = r <= kMaskBelow ? __int_as_float(0xff800000) : r;
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
// at 3.35 TB/s, against 2.6e10 int8 operations (0.013 ms at the int8 peak). The 16-fold
// overcompute goes to the tensor cores, so that only the bytes are left:
// - The products are warp-level mma.sync.m16n8k32 s8 tiles: A is the tile's queries (its
//   16 rows are the most queries a tile holds; rows past qg read a zero segment), B eight
//   slab rows. Four accumulators take q1.c1, q1.c2, q2.c1 and q2.c2 over K = d (zero-padded
//   to a multiple of 32), a fifth (two, alternating k-steps) the keyword dot over the bloom
//   bits. The sums are exact int32, so their order is free and the result bitwise.
// - A block takes one tile and a run of its row blocks (kSlabRows slab rows each). Its
//   consumer warps stage the tile's keyword weights into shared memory, reordered to the
//   kernel's K order of the bloom bits (slab_kw_pos; JAX column j of the bit matrix is bit
//   j / W of word j % W): the four k-steps of a 16-byte bloom chunk then take their B
//   registers from one 32-bit word a thread, as bit planes (two instructions a register).
// - The slab rows stream through a ring of 2-3 stages (c1, c2, bloom and the four
//   sidecars), filled by 16-byte cp.async copies of producer warps that do nothing else;
//   the query planes go out with the first stage. A stage is handed over by named
//   barriers, full (the producers' copies are in) and empty (the consumers are done).
//   Row strides are 16 bytes times an odd number, so ldmatrix (planes) and the bloom's
//   word loads meet no bank conflict. Each consumer warp takes one n8 tile of a stage.
// - On the H100 a warp's cp.async copies are accepted only as fast as the memory system
//   retires them, and they share the load/store pipe with the consumers' ldmatrix: with
//   copies and products in the same warps each waited for the other, and one producer
//   warp alone could not keep bytes in flight. Eight producer warps beside eight
//   consumers came out fastest among the layouts timed (tools/slab_split.py, PERF.md).
// - Rows too wide for the ring are cut into chunks of K, the accumulators carried from
//   chunk to chunk: at d = 768, W = 128 a stage of 64 rows takes K in two chunks.
// - The epilogue runs from the C fragments, K3's combine op for op, and stores float2
//   pairs (four lanes write 32 contiguous bytes of a query's row); rows >= qg and slab
//   rows >= ct are never written.
// A separate kernel with its own argument block, so that refine_kernel's register
// allocation stays as it was.

constexpr int kSlabQg = 16;                        // the mma's rows: most queries a tile holds
constexpr int kSlabWarps = 8;                      // consumer warps: an n8 tile of a stage each
constexpr int kSlabProducers = 8;                  // producer warps: the ring's copies
constexpr int kSlabConsumerThreads = 32 * kSlabWarps;
constexpr int kSlabThreads = 32 * (kSlabWarps + kSlabProducers);
constexpr int kSlabRows = 8 * kSlabWarps;          // slab rows a stage holds
constexpr int kSlabMaxStages = 3;
// named barriers (0 is __syncthreads'): the consumers' own, then each stage's full and empty
constexpr int kBarConsumers = 1, kBarFull = 2, kBarEmpty = kBarFull + kSlabMaxStages;
constexpr int kSlabSides = 4;                      // s1, s2, ec2, add
constexpr int kSlabTermBytes = 5 * kSlabQg * 4;    // t1, t2, eq2, qn, kwb of each query

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
  int kp;           // plane k-steps (32 bytes of c1 and of c2) a chunk
  int kb;           // 16-byte bloom words (four keyword k-steps) a chunk
  int chunks;       // chunks a row block
  int stages;       // the ring's stages: 2 or 3
  int rb_per_block; // row blocks (kSlabRows slab rows) a block takes
};

// T3's dynamic shared memory (byte offsets): the queries' terms, a 16-byte zero segment,
// A's planes [qg][32 * sd + 16] and keyword weights [qg][128 * nw + 16], then the ring,
// each stage c1 and c2 [kSlabRows][32 * kp + 16], bloom [kSlabRows][16 * (kb | 1)] and
// the sidecars [4][kSlabRows] f32
struct SlabLayout {
  int sd;         // plane k-steps: ceil(d / 32)
  int nw;         // bloom words: ceil(W / 16)
  int a_stride, kw_stride, c_stride, b_stride;
  int zero, a1, a2, akw, ring;
  int stage;      // bytes a stage
  int c2, bl, side;  // offsets within a stage
};

__host__ __device__ inline SlabLayout slab_layout(int d, int w, int qg, int kp, int kb) {
  SlabLayout l;
  l.sd = (d + 31) / 32;
  l.nw = (w + 15) / 16;
  l.a_stride = 32 * l.sd + 16;
  l.kw_stride = 128 * l.nw + 16;
  l.c_stride = 32 * kp + 16;
  l.b_stride = 16 * (kb | 1);
  l.zero = kSlabTermBytes;
  l.a1 = l.zero + 16;
  l.a2 = l.a1 + qg * l.a_stride;
  l.akw = l.a2 + qg * l.a_stride;
  l.ring = l.akw + qg * l.kw_stride;
  l.c2 = kSlabRows * l.c_stride;
  l.bl = 2 * kSlabRows * l.c_stride;
  l.side = l.bl + kSlabRows * l.b_stride;
  l.stage = l.side + 4 * kSlabSides * kSlabRows;
  return l;
}

// the position of bloom byte x's bit b in a query's row of the keyword A operand: the four
// k-steps 4 * (x / 16) + b / 2 take the bytes of every slab row's 16-byte chunk x / 16,
// a thread (lane % 4 = t) its 32-bit word t, bytes 4t .. 4t + 3; in k-step 4 * (x / 16) + r
// its B registers are bit planes 2r and 2r + 1 of that word (B's k 4t + i and 16 + 4t + i
// are bits 2r and 2r + 1 of its byte i)
__device__ __forceinline__ int slab_kw_pos(int x, int b) {
  return 32 * (4 * (x >> 4) + (b >> 1)) + 16 * (b & 1) + 4 * ((x >> 2) & 3) + (x & 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b: one m16n8k32 s8 tile, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the copies of ring iteration `it` (row block it / chunks, chunk it % chunks) into its
// stage, by the producer warps (pw, lane); row blocks past the block's last issue nothing
__device__ __forceinline__ void slab_issue(const SlabArgs& a, const SlabLayout& l,
                                           unsigned char* smem, int it, int rb_end, int pw,
                                           int lane) {
  const int rb = it / a.chunks, c = it - rb * a.chunks;
  if (rb >= rb_end) return;
  unsigned char* st = smem + l.ring + (size_t)(it % a.stages) * l.stage;
  const int j0 = (blockIdx.x * a.rb_per_block + rb) * kSlabRows;
  const size_t base = (size_t)blockIdx.y * a.ct;  // the tile's first slab row
  const int lo = 32 * a.kp * c;                    // the chunk's first byte of a plane row
  const int pieces = (min(32 * a.kp, a.d - lo) + 15) / 16;
  const int wlo = a.kb * c;                        // the chunk's first bloom word
  const int words = min(a.kb, l.nw - wlo);
  const bool vec_bloom = (a.w & 15) == 0;
  for (int r = pw; r < kSlabRows; r += kSlabProducers) {
    const int j = j0 + r;
    if (j >= a.ct) break;
    const size_t row = base + j;
    const int8_t* g1 = a.c1 + row * a.d + lo;
    const int8_t* g2 = a.c2 + row * a.d + lo;
    unsigned char* s1 = st + r * l.c_stride;
    for (int x = lane; x < pieces; x += 32) {
      cp_async16(s1 + 16 * x, g1 + 16 * x);
      cp_async16(s1 + l.c2 + 16 * x, g2 + 16 * x);
    }
    const uint8_t* gb = a.bloom + row * a.w + 16 * wlo;
    unsigned char* sb = st + l.bl + r * l.b_stride;
    if (vec_bloom) {
      for (int x = lane; x < words; x += 32) cp_async16(sb + 16 * x, gb + 16 * x);
    } else {  // rows not 16-byte aligned: bytes through registers, those past W left as
              // they are (their keyword weights are zero)
      const int bytes = min(16 * words, a.w - 16 * wlo);
      for (int x = lane; x < bytes; x += 32) sb[x] = __ldg(gb + x);
    }
  }
  if (c == a.chunks - 1) {  // the sidecars go with the chunk whose epilogue reads them
    float* side = reinterpret_cast<float*>(st + l.side);
    for (int i = 32 * pw + lane; i < kSlabSides * kSlabRows; i += 32 * kSlabProducers) {
      const int v = i / kSlabRows, r = i - v * kSlabRows;
      const float* sv = v == 0 ? a.s1 : v == 1 ? a.s2 : v == 2 ? a.ec2 : a.add;
      if (j0 + r < a.ct) cp_async4(side + i, sv + base + j0 + r);
    }
  }
}

// the producer warps: the queries' int8 planes with the first stage, then each stage once
// its slot is empty, marked full when its copies are in (cp.async completes by thread)
__device__ void slab_produce(const SlabArgs& a, const SlabLayout& l, unsigned char* smem,
                             int q0, int rb_end, int pw, int lane) {
  const int dv = a.d / 16;  // 16-byte pieces of a plane row
  for (int g = pw; g < a.qg; g += kSlabProducers) {
    const int8_t* g1 = a.q1 + (size_t)(q0 + g) * a.d;
    const int8_t* g2 = a.q2 + (size_t)(q0 + g) * a.d;
    unsigned char* s1 = smem + l.a1 + g * l.a_stride;
    unsigned char* s2 = smem + l.a2 + g * l.a_stride;
    for (int x = lane; x < dv; x += 32) {
      cp_async16(s1 + 16 * x, g1 + 16 * x);
      cp_async16(s2 + 16 * x, g2 + 16 * x);
    }
    if (lane == 0 && (dv & 1)) {  // K's zero padding to a whole k-step
      *reinterpret_cast<int4*>(s1 + a.d) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(s2 + a.d) = make_int4(0, 0, 0, 0);
    }
  }
  const int iters = rb_end * a.chunks, ahead = a.stages - 1;
  for (int it = 0; it < iters; ++it) {
    if (it >= a.stages) bar_sync(kBarEmpty + it % a.stages, kSlabThreads);
    slab_issue(a, l, smem, it, rb_end, pw, lane);
    cp_async_commit();
    if (it >= ahead) {  // stage it - ahead is in
      if (ahead == 2) cp_async_wait<2>(); else cp_async_wait<1>();
      bar_arrive(kBarFull + (it - ahead) % a.stages, kSlabThreads);
    }
  }
  cp_async_wait<0>();
  for (int it = max(0, iters - ahead); it < iters; ++it)
    bar_arrive(kBarFull + it % a.stages, kSlabThreads);
}

__global__ void __launch_bounds__(kSlabThreads, 1) refine_slab_kernel(SlabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlabLayout l = slab_layout(a.d, a.w, a.qg, a.kp, a.kb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * a.qg;
  const int rb_first = blockIdx.x * a.rb_per_block;
  const int rb_end = min(a.rb_per_block, (a.ct + kSlabRows - 1) / kSlabRows - rb_first);
  const int iters = rb_end * a.chunks;

  if (warp >= kSlabWarps) {
    slab_produce(a, l, smem, q0, rb_end, warp - kSlabWarps, lane);
    return;
  }

  float(*sterm)[kSlabQg] = reinterpret_cast<float(*)[kSlabQg]>(smem);
  if (tid < kSlabQg) {
    const bool q = tid < a.qg;
    sterm[0][tid] = q ? a.t1[q0 + tid] : 0.0f;
    sterm[1][tid] = q ? a.t2[q0 + tid] : 0.0f;
    sterm[2][tid] = q ? a.eq2[q0 + tid] : 0.0f;
    sterm[3][tid] = q ? a.qn[q0 + tid] : 0.0f;
    sterm[4][tid] = q ? a.kwb[q0 + tid] : 0.0f;
  }
  if (tid == 0) *reinterpret_cast<int4*>(smem + l.zero) = make_int4(0, 0, 0, 0);
  // the keyword weights, a 32-bit word of A a thread: bit b of bloom bytes x .. x + 3, JAX
  // columns b * W + x .. b * W + x + 3 (zero past W)
  const int kw_words = 32 * l.nw;  // of a query's row
#pragma unroll 4
  for (int i = tid; i < a.qg * kw_words; i += kSlabConsumerThreads) {
    const int g = i / kw_words, p = i - g * kw_words;
    const int b = p / (4 * l.nw), x = 4 * (p - b * 4 * l.nw);
    const uint8_t* kw =
        reinterpret_cast<const uint8_t*>(a.kw_w8) + (size_t)(q0 + g) * 8 * a.w + b * a.w + x;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (x + e < a.w) word |= (uint32_t)__ldg(kw + e) << (8 * e);
    *reinterpret_cast<uint32_t*>(smem + l.akw + g * l.kw_stride + slab_kw_pos(x, b)) = word;
  }

  // ldmatrix addresses: lane L reads row L % 8 of matrix L / 8. A's matrices are query
  // rows 0-7 and 8-15 at k 0-15, then at k 16-31; a query row past qg reads the zero
  // segment at every k-step. B's are c1's eight rows at k 0-15 and 16-31, then c2's.
  const int mat = lane >> 3, mrow = lane & 7;
  const int qrow = mrow + 8 * (mat & 1);
  const bool qlive = qrow < a.qg;
  const unsigned zero = smem_addr(smem + l.zero);
  const unsigned a1_base = qlive ? smem_addr(smem + l.a1 + qrow * l.a_stride + 16 * (mat >> 1)) : zero;
  const unsigned a2_base = qlive ? smem_addr(smem + l.a2 + qrow * l.a_stride + 16 * (mat >> 1)) : zero;
  const unsigned kw_base = qlive ? smem_addr(smem + l.akw + qrow * l.kw_stride + 16 * (mat >> 1)) : zero;
  const int a_step = qlive ? 32 : 0;
  const int b_off = (mat >> 1) * l.c2 + (8 * warp + mrow) * l.c_stride + 16 * (mat & 1);
  const int grp = lane >> 2, quad = lane & 3;  // the fragments' row (query, slab row) and pair

  bar_sync(kBarConsumers, kSlabConsumerThreads);  // the keyword weights and terms are in

  int acc[4][4], kwacc[2][4];
  for (int it = 0; it < iters; ++it) {
    bar_sync(kBarFull + it % a.stages, kSlabThreads);
    const int rb = it / a.chunks, c = it - rb * a.chunks;
    const unsigned char* st = smem + l.ring + (size_t)(it % a.stages) * l.stage;
    if (c == 0) {
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[v][e] = kwacc[v & 1][e] = 0;
    }
    // planes: d11 = q1.c1, d12 = q1.c2, d21 = q2.c1, d22 = q2.c2
    const int s0 = a.kp * c, ns = min(a.kp, l.sd - s0);
    const unsigned b_base = smem_addr(st) + b_off;
#pragma unroll 2
    for (int s = 0; s < ns; ++s) {
      uint32_t qa[4], qb[4], cb[4];
      ldmatrix_x4(a1_base + a_step * (s0 + s), qa);
      ldmatrix_x4(a2_base + a_step * (s0 + s), qb);
      ldmatrix_x4(b_base + 32 * s, cb);
      mma_s8(acc[0], qa, cb[0], cb[1]);
      mma_s8(acc[1], qa, cb[2], cb[3]);
      mma_s8(acc[2], qb, cb[0], cb[1]);
      mma_s8(acc[3], qb, cb[2], cb[3]);
    }
    // keyword: four k-steps a 16-byte bloom chunk, whose bit planes 2r and 2r + 1 of this
    // thread's word are B's registers in k-step 4u + r
    const int w0 = a.kb * c, nwc = min(a.kb, l.nw - w0);
    const unsigned char* bl = st + l.bl + (8 * warp + grp) * l.b_stride + 4 * quad;
#pragma unroll 2
    for (int u = 0; u < nwc; ++u) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(bl + 16 * u);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t kq[4];
        ldmatrix_x4(kw_base + a_step * (4 * (w0 + u) + r), kq);
        mma_s8(kwacc[r & 1], kq, (word >> (2 * r)) & 0x01010101u,
               (word >> (2 * r + 1)) & 0x01010101u);
      }
    }
    if (c != a.chunks - 1) {
      if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);
      continue;
    }

    // epilogue: C element e holds query grp + 8 * (e / 2) against slab row 2 * quad + e % 2
    // of this warp's eight
    const float* side = reinterpret_cast<const float*>(st + l.side);
    const int n0 = 8 * warp + 2 * quad;
    const int j = (rb_first + rb) * kSlabRows + n0;
    float res[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = grp + 8 * (e >> 1), n = n0 + (e & 1);
      const float s1 = side[n], s2 = side[kSlabRows + n];
      const float ec2 = side[2 * kSlabRows + n], add = side[3 * kSlabRows + n];
      const float t1 = sterm[0][g], t2 = sterm[1][g];
      const float pa = __fmaf_rn(t1, (float)acc[0][e], __fmul_rn(t2, (float)acc[2][e]));
      const float pb = __fmaf_rn(t1, (float)acc[1][e], __fmul_rn(t2, (float)acc[3][e]));
      const float cos = __fmaf_rn(s1, pa, __fmul_rn(s2, pb));
      const float delta =
          __fmaf_rn(sterm[3][g], ec2, __fmul_rn(sterm[2][g], __fadd_rn(1.0f, ec2)));
      const float kw =
          fminf(__fmaf_rn((float)(kwacc[0][e] + kwacc[1][e]), kInv127, sterm[4][g]), 1.0f);
      res[e] = __fadd_rn(__fmaf_rn(kKwW, kw, __fmul_rn(kCosW, __fadd_rn(cos, delta))), add);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = grp + 8 * h;
      if (g >= a.qg || j >= a.ct) continue;
      float* o = a.out + (size_t)(q0 + g) * a.ct + j;
      if ((a.ct & 1) == 0) {  // j and ct even: an aligned pair, both in the tile
        *reinterpret_cast<float2*>(o) = make_float2(res[2 * h], res[2 * h + 1]);
      } else {
        o[0] = res[2 * h];
        if (j + 1 < a.ct) o[1] = res[2 * h + 1];
      }
    }
    if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);
  }
}

}  // namespace

// emb1/emb2 i8[n, d], bloom u8[n, w], scale1/scale2/err2/created f32[n], valid bool[n],
// q f32[b, d], kw_w8 i8[b, 8w], kw_b f32[b], rows i32[b, m] and vals f32[b, m] with row
// strides rows_stride and vals_stride, now (days) -> out f32[b, m]
extern "C" int omni_refine(const void* emb1, const void* emb2, const void* bloom,
                           const void* scale1, const void* scale2, const void* err2,
                           const void* valid, const void* created, const void* q,
                           const void* kw_w8, const void* kw_b, const void* rows,
                           const void* vals, void* out, float now, int n, int d, int w, int b,
                           int m, int rows_stride, int vals_stride, void* stream) {
  if (n <= 0 || d <= 0 || d % 16 != 0 || w <= 0 || b <= 0 || m <= 0 || b > 65535 ||
      rows_stride < m || vals_stride < m)
    return -1;
  const size_t smem = refine_smem(d, w);
  if (smem > (size_t)kMaxSmem) return -1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.emb1 = static_cast<const int8_t*>(emb1);
  a.emb2 = static_cast<const int8_t*>(emb2);
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.scale1 = static_cast<const float*>(scale1);
  a.scale2 = static_cast<const float*>(scale2);
  a.err2 = static_cast<const float*>(err2);
  a.valid = static_cast<const bool*>(valid);
  a.created = static_cast<const float*>(created);
  a.q = static_cast<const float*>(q);
  a.kw_w8 = static_cast<const int8_t*>(kw_w8);
  a.kw_b = static_cast<const float*>(kw_b);
  a.rows = static_cast<const int32_t*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.out = static_cast<float*>(out);
  a.now = now;
  a.n = n; a.d = d; a.w = w; a.m = m;
  a.rows_stride = rows_stride; a.vals_stride = vals_stride;
  // a query's candidates in as few tiles as fill the card: each tile quantizes the query
  const int steps = (m + kStep - 1) / kStep;
  const int tiles = std::max(1, std::min(steps, (kBlocksPerSm * sms + b - 1) / b));
  a.cand_per_block = (steps + tiles - 1) / tiles * kStep;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + a.cand_per_block - 1) / a.cand_per_block, b);
  refine_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// created f32[n], now (days) -> out f32[n]: refine_kernel's recency term of every row; with
// exp_only, created holds the exp's arguments and out their exp
extern "C" int omni_recency(const void* created, void* out, float now, int n, int exp_only,
                            void* stream) {
  if (n <= 0) return -1;
  recency_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(created), static_cast<float*>(out), now, n, exp_only != 0);
  return (int)cudaGetLastError();
}

// T3. q1/q2 i8[b, d], t1/t2/eq2/qn/kwb f32[b], kw_w8 i8[b, 8w], c1/c2 i8[b*m, d],
// bloom u8[b*m, w], s1/s2/ec2/add f32[b*m] -> out f32[b, qg*m]; b % qg == 0, every
// pointer 16-byte aligned
extern "C" int omni_refine_slab(const void* q1, const void* q2, const void* t1, const void* t2,
                                const void* eq2, const void* qn, const void* kwb,
                                const void* kw_w8, const void* c1, const void* c2,
                                const void* bloom, const void* s1, const void* s2,
                                const void* ec2, const void* add, void* out, int b, int d,
                                int w, int m, int qg, void* stream) {
  if (b <= 0 || d <= 0 || d % 16 != 0 || w <= 0 || m <= 0 || qg < 1 || qg > kSlabQg ||
      b % qg != 0 || b / qg > 65535 || d > (1 << 20) || w > (1 << 20) ||
      (long long)qg * m > (1 << 30))
    return -1;
  // the whole of K in one chunk where three (else two) stages fit beside the queries,
  // else as few chunks as let two fit
  const int sd = (d + 31) / 32, nw = (w + 15) / 16;
  int kp = sd, kb = nw, stages = 0;
  for (int chunks = 1; !stages; ++chunks) {
    kp = (sd + chunks - 1) / chunks;
    kb = (nw + chunks - 1) / chunks;
    const SlabLayout l = slab_layout(d, w, qg, kp, kb);
    stages = l.ring + 3 * l.stage <= kMaxSmem ? 3 : l.ring + 2 * l.stage <= kMaxSmem ? 2 : 0;
    if (!stages && kp == 1 && kb == 1) return -1;
  }
  const SlabLayout l = slab_layout(d, w, qg, kp, kb);
  const int smem = l.ring + stages * l.stage;
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
  a.kp = kp; a.kb = kb; a.stages = stages;
  a.chunks = std::max((sd + kp - 1) / kp, (nw + kb - 1) / kb);
  cudaError_t err = cudaFuncSetAttribute(refine_slab_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refine_slab_kernel,
                                                        kSlabThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  // the row blocks a block takes: the fewest waves of blocks times the row blocks of each,
  // a block's staging of its queries counted as kSlabSetup row blocks
  constexpr long long kSlabSetup = 2;
  const int tiles = b / qg, nrb = (a.ct + kSlabRows - 1) / kSlabRows;
  const long long slots = (long long)sms * per_sm;
  long long best = -1;
  for (int per = 1; per <= std::min(nrb, 4096); ++per) {
    const long long blocks = (long long)tiles * ((nrb + per - 1) / per);
    const long long cost = (blocks + slots - 1) / slots * (per + kSlabSetup);
    if (best < 0 || cost < best) {
      best = cost;
      a.rb_per_block = per;
    }
  }
  dim3 grid((nrb + a.rb_per_block - 1) / a.rb_per_block, tiles);
  refine_slab_kernel<<<grid, kSlabThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
