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

constexpr int kThreads = 256;  // T3's block
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
