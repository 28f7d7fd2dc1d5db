// Hand-written Hopper (sm_90a) kernel for the fused f32/bf16 hybrid scan, K6,
// on the tensor cores (wgmma, bf16 in, f32 accumulators).
//
// Replaces omni_recall_tpu/ops/pallas_scorer.py block_topt (the pallas_call at
// :737, body _make_topt_kernel :191 with _ub_block :74):
//
//   cos   = sum_k bf16(q[b, k]) * bf16(emb[r, k])                (f32 sum)
//   kwd   = sum_j bf16(kw_w[b, j]) * bit_j(bloom[r])             (f32 sum)
//   kw    = min(kwd + kw_b[b], 1)
//   score = fma(0.7, cos, 0.2 * kw) + add_row[r] + 8e-3
//
// then the per-slice top-(t1-1) + bound extraction of _extract_topt
// (topt_extract.cuh), writing the decoded [B, slices, t1] contract. bf16(x) is
// x rounded to bf16 to nearest, ties to even (the kernel's astype(bfloat16)).
// Bit j of a bloom row is bit j / W of byte j % W. The epilogue keeps the
// f32 operation order XLA's compiler gives the JAX graph (__fmaf_rn where it
// contracts, one rounding per operation elsewhere; the library builds with
// -fmad=false).
//
// Sum order and the parity rule. The two dots run on wgmma.mma_async
// .f32.bf16.bf16; PTX fixes neither the order in which it adds the products
// of a k-step nor how it rounds inside one, so no plain version reproduces it
// bit for bit. The plain version (ops/scorer.py _seq_dot) sums in k order,
// one rounding a term. Both are exact where every partial sum is exact, and
// there the kernel matches it bit for bit. Elsewhere each side is within
// g(n) = n 2^-23 times the sum of the terms' magnitudes of the exact sum
// (truncating accumulation), so
//   |kernel - plain| <= 0.7 * 2g(d) * max_r sum_i |q_i c_i|
//                       + 0.2 * 2g(8W) * sum_j w_j (1 + 2^-8) + (4 + granule) ulp
// (ops/scorer.py fp_order_bound; granule = sub ulps where packed keys carry
// lane bits). The certificate eps stays PALLAS_CERT_EPS = 8e-3: it was
// derived for the bf16 rounding of both operands, 0.0055 on the weighted
// cosine plus 0.001 on the keyword term (pallas_scorer.py:23-32), which
// leaves 1.5e-3; the hardware's accumulation adds at most 0.7 * 768 * 2^-23
// + 0.2 * 1024 * 2^-23 * 1.2 = 9.3e-5 against the exact sum of the rounded
// operands at the serving shape (d = 768, 1024 bloom bits, unit rows and
// queries, keyword weights summing to <= 1.2), well inside it.
//
// What bounds it on the H100: at the serving shapes (N = 2^20, d = 768,
// W = 128, B = 448) 2*N*B*(d + 8W) = 1.68e12 operations, 1.70 ms at the bf16
// tensor-core peak, against 1.75 GB (bf16 rows) or 3.36 GB (f32 rows) of
// reads, 0.52 / 1.00 ms at 3.35 TB/s: operation-bound at the card's peak.
// This design streams every row once per query tile of QT queries, so its
// own floor is the L2-to-SM traffic: B / QT tiles x the rows' bytes (14 x
// 1.6 GB of bf16 rows at QT = 32).
//
// Design. Rows are operand A (M = 64 rows a consumer warpgroup, two
// warpgroups: 128 rows a tile); the query tile is operand B (N = QT = 32, 16
// or 8 queries, the largest whose operands and scores fit in shared memory).
// The queries' operand stays resident: the wrapper rounds q and the keyword
// weights to bf16 once a batch and lays them out as one [B', 64 ceil(d/64) +
// 8 W'] matrix (W' = W rounded up to 16, d and W' zero-padded), which TMA
// loads once a block in 128-byte swizzled atoms (64 bf16 of K). A 64-query
// tile as operand A, as on the TPU, would need 64 x 1792 x 2 = 229 KB of
// resident operands: more than a block's 227 KB.
// - Cosine dot: a producer warpgroup fills a ring of kStages stages, each a
//   [128 rows x 64 K] bf16 tile in the 128-byte swizzle, guarded by
//   mbarriers (full: loaded; empty: both consumer warpgroups done). bf16 rows
//   with d % 8 == 0 arrive by TMA (cp.async.bulk.tensor, zero fill past d);
//   f32 rows (and bf16 rows with d % 8 == 4) are loaded 16 bytes a thread,
//   rounded with __float22bfloat162_rn and stored into the swizzled layout by
//   the producer's 128 threads. Each stage is four m64nQTk16 wgmmas per
//   consumer warpgroup, both operands from shared memory.
// - Keyword dot: operand A comes from registers. The wrapper permutes the
//   keyword-weight columns so that in k-step ks = 8 s + p each thread's four
//   A columns are bit plane p of four consecutive bloom bytes,
//   quad * W'/4 + 4 s + 0..3: one 32-bit load a row gives the thread its
//   A fragments for all eight planes of step s (byte_perm, then a shift, a
//   mask and a multiply by 0x3F80 make bf16 0/1 pairs). Bytes past W are 0.
//   The bloom bytes are read once a tile, with no divisions and no shared
//   memory.
// - The scores stay on the SM: the epilogue runs on the accumulators and
//   stores f32 scores into a [QT][R + 4] shared buffer (R = max(sub, 128)
//   rows, one group of whole slices; the pad spreads the stores over the
//   banks); the eight consumer warps then run the literal max-and-mask rounds
//   of topt_extract.cuh on it, each lane's scores of a slice held in
//   registers (extract_regs; shared memory for slices other than 128-1024
//   rows), while the producer already loads the next group's rows. No
//   [B, N] matrix goes to device memory.
// - Launch order for L2: grid.x is the query tile, so the B / QT tiles of one
//   row block are adjacent in launch order and read its rows from device
//   memory once, from L2 after that. A block walks G groups (G a power of
//   two, at least 8 waves of blocks), so the resident operand is loaded once
//   for G * R rows.
//
// The same kernel serves the profiling probe T1 (tools/profile_kernel.py, the
// pallas_call at :26 with the bodies mk_cos_only :53, mk_cos_kw :60, mk_full
// :72), which splits this body three ways over bf16 rows and blocks of c
// rows: T1-cos writes cos itself (no keyword operand, no keyword dot),
// T1-coskw the score without the eps, score = fma(0.7, cos, 0.2 * kw) +
// add_row, both for the first 128 rows of each block ([N/c, B, 128]), and
// T1-full the nine largest scores of each block ([B, N/c, 9], values only;
// extract_query's two-reduce mode with sub = c). Every variant computes all
// c rows of a block, as the TPU body computes the whole [B, c] product;
// T1-cos and T1-coskw keep only the first 128 rows' scores in shared memory,
// so their query tile is larger than T1-full's. Bounds at N = 2^20, d = 768,
// W = 128, B = 448: cos 2*N*B*d = 7.2e11 operations, 0.73 ms at the bf16
// peak; coskw and full as K6, 1.70 ms.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "topt_extract.cuh"

namespace {

constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kThreads = 3 * kWg;         // producer warpgroup + two consumers
constexpr int kConsumers = 2 * kWg;
constexpr int kMaxSmem = 232448;
constexpr int kTileRows = 128;            // rows of a stage: 64 per consumer warpgroup
constexpr int kChunk = 64;                // K values of a stage: one 128-byte swizzle atom
constexpr int kStages = 3;
constexpr int kStageBytes = kTileRows * kChunk * 2;
constexpr int kScorePad = 4;              // floats of padding per score row
constexpr int kMaxQt = 32;                // the wrapper pads B to a multiple of this
constexpr int kWaveBlocks = 132 * 8;      // at least this many blocks, where the rows allow
constexpr int kMaxGroups = 64;            // groups a block walks at most
constexpr float kEps = 8e-3f;             // PALLAS_CERT_EPS
constexpr float kCosW = 0.7f;             // COSINE_WEIGHT
constexpr float kKwW = 0.2f;              // KEYWORD_WEIGHT
constexpr int kT1Wide = 128;              // rows of a block T1-cos / T1-coskw write
constexpr int kT1Top = 9;                 // values of a block T1-full writes

// what the kernel computes: K6, or one of the T1 probe's three bodies
enum Variant : int { kK6 = 0, kT1Cos = 1, kT1CosKw = 2, kT1Full = 3 };
// how rows reach the ring: TMA (bf16, d % 8 == 0) or the producer's loads
enum RowSrc : int { kTmaBf16 = 0, kLoadF32 = 1, kLoadBf16 = 2 };

struct Args {
  const void* emb;        // rows, f32 or bf16 [n, d]
  const uint8_t* bloom;   // [n, w]
  const float* kw_b;      // [b]
  const float* add_row;   // [n]
  float* out_vals;
  int32_t* out_idxs;
  int n, d, w, b, sub, t1, packed;
  int wp;                 // w rounded up to 16
  int kq, kk;             // 64-wide K chunks of the cosine and keyword operands
  int rows_per_group;     // R: whole slices (K6) or one block of c rows (T1)
  int groups;             // G: groups a block walks
};

using namespace omni;

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N]: A from shared memory (ss) or
// registers (rs), B from shared memory, f32 accumulators in registers
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// bit plane p of a row's two bytes held at bits 0 and 16: bf16 0 or 1 pairs
__device__ __forceinline__ uint32_t plane_bits(uint32_t y, int p) {
  return ((y >> p) & 0x00010001u) * 0x3F80u;
}

// the four bloom bytes quad * W'/4 + 4 s + 0..3 of one row (0 past W)
__device__ __forceinline__ uint32_t bloom_word(const Args& a, const uint8_t* row, int byte0) {
  if ((a.w & 15) == 0) return __ldg(reinterpret_cast<const uint32_t*>(row + byte0));
  uint32_t x = 0;
#pragma unroll
  for (int o = 0; o < 4; ++o)
    if (byte0 + o < a.w) x |= static_cast<uint32_t>(__ldg(row + byte0 + o)) << (8 * o);
  return x;
}

// score columns a block keeps per query: the group's rows, or T1-cos /
// T1-coskw's first 128
__host__ __device__ constexpr int score_cols(int variant, int rows_per_group) {
  return (variant == kT1Cos || variant == kT1CosKw) ? kT1Wide : rows_per_group;
}

constexpr size_t smem_bytes(int qt, int kq, int kk, int cols) {
  return 1024 + (size_t)qt * 128 * (kq + kk) + (size_t)kStages * kStageBytes +
         (size_t)qt * (cols + kScorePad) * 4 + (2 * kStages + 1) * 8;
}

// the producer's 16-byte loads: eight row values from k0 on (0 past d),
// rounded to bf16 pairs
template <int RS>
__device__ __forceinline__ uint4 load_row_chunk(const Args& a, long row, int k0) {
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  if (RS == kLoadF32) {
    const float* src = static_cast<const float*>(a.emb) + (size_t)row * a.d + k0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (k0 + 4 * half < a.d) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + half);
        const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v.x, v.y));
        const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v.z, v.w));
        h[2 * half] = *reinterpret_cast<const uint32_t*>(&lo);
        h[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
    }
  } else {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.emb) + (size_t)row * a.d + k0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (k0 + 4 * half < a.d) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + half);
        h[2 * half] = v.x;
        h[2 * half + 1] = v.y;
      }
    }
  }
  return make_uint4(h[0], h[1], h[2], h[3]);
}

template <int RS, int QT, int VAR>
__global__ void __launch_bounds__(kThreads, 1)
    fp_scan_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap rmap, Args a) {
  constexpr bool kKw = VAR != kT1Cos;  // T1-cos has no keyword terms
  constexpr int NACC = QT / 2;         // accumulator registers a thread, per dot
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kchunks = a.kq + (kKw ? a.kk : 0);
  unsigned char* bq = sm;                                  // [kchunks][QT][128 B]
  unsigned char* ring = bq + (size_t)QT * 128 * kchunks;   // [kStages][128 rows][128 B]
  float* sc = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  const int R = a.rows_per_group;
  const int SS = score_cols(VAR, R) + kScorePad;           // score row stride
  uint64_t* bars = reinterpret_cast<uint64_t*>(sc + (size_t)QT * SS);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const uint32_t bq_full = smem_u32(bars + 2 * kStages);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const long row_base = (long)blockIdx.y * a.groups * R;
  const int tiles = a.groups * (R / kTileRows);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, RS == kTmaBf16 ? 1 : kWg);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(bq_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer warpgroup ----
    if (tid == 0) {  // the resident query operand, once
      mbar_expect_tx(bq_full, (uint32_t)(QT * 128 * kchunks));
      for (int c = 0; c < kchunks; ++c)
        tma_load_2d(smem_u32(bq + (size_t)c * QT * 128), &qmap, c * kChunk, q0, bq_full);
    }
    if (RS == kTmaBf16 && tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      const long row0 = row_base + (long)t * kTileRows;
      for (int kc = 0; kc < a.kq; ++kc) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t dst = smem_u32(ring + stage * kStageBytes);
        if (RS == kTmaBf16) {
          mbar_expect_tx(full0 + 8 * stage, kStageBytes);
          tma_load_2d(dst, &rmap, kc * kChunk, (int)row0, full0 + 8 * stage);
        } else {
          // 1024 16-byte units a stage, 8 a thread: unit u is row u / 8,
          // atom word u % 8, stored at the word's swizzled place
          uint4 v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int u = tid + kWg * i;
            v[i] = load_row_chunk<RS>(a, row0 + (u >> 3), kc * kChunk + (u & 7) * 8);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int u = tid + kWg * i, r = u >> 3;
            const uint32_t off = r * 128 + ((((u & 7) ^ (r & 7))) << 4);
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + off),
                         "r"(v[i].x), "r"(v[i].y), "r"(v[i].z), "r"(v[i].w)
                         : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full0 + 8 * stage);
        }
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int ctid = tid - kWg, cw = ctid >> 5, lane = tid & 31;
  const int g = cw >> 2;                                  // which 64 rows of a tile
  const int rl0 = g * 64 + (cw & 3) * 16 + (lane >> 2);   // accumulator rows rl0, rl0 + 8
  const int quad = lane & 3;
  const uint32_t bq_addr = smem_u32(bq), ring_addr = smem_u32(ring);
  const int steps = a.wp >> 4;                            // keyword k-steps / 8
  const int quad_byte = quad * (a.wp >> 2);

  float kb[NACC / 2];  // keyword bias of the thread's queries (j8 * 8 + quad * 2 + h)
#pragma unroll
  for (int i = 0; i < NACC / 2; ++i) {
    const int qg = q0 + (i >> 1) * 8 + quad * 2 + (i & 1);
    kb[i] = (kKw && qg < a.b) ? a.kw_b[qg] : 0.0f;
  }
  mbar_wait(bq_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  const long n_slices = a.n / a.sub;
  for (int grp = 0; grp < a.groups; ++grp) {
    const long grow0 = row_base + (long)grp * R;
    for (int tt = 0; tt < R / kTileRows; ++tt) {
      const long trow = grow0 + (long)tt * kTileRows;
      float acc_c[NACC], acc_k[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc_c[i] = acc_k[i] = 0.0f;

      // cosine: A = the stage's rows, B = the resident queries. A stage goes
      // back to the producer as soon as its wgmmas are done: with three
      // stages, holding one a chunk longer leaves the producer one stage of
      // prefetch, and the rows come from L2 at its latency.
      for (int kc = 0; kc < a.kq; ++kc) {
        mbar_wait(full0 + 8 * stage, phase);
        wg_fence();
        const uint32_t a_addr = ring_addr + stage * kStageBytes + g * 64 * 128;
        const uint32_t b_addr = bq_addr + kc * QT * 128;
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
          wgmma_ss<QT>(acc_c, sw128_desc(a_addr + ks * 32), sw128_desc(b_addr + ks * 32));
        wg_commit();
        wg_wait_all();
        mbar_arrive(empty0 + 8 * stage);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }

      // keyword: A = bit planes of the bloom bytes in registers, B = the
      // resident (permuted) keyword weights
      if (kKw) {
        const uint8_t* row_a = a.bloom + (size_t)(trow + rl0) * a.w;
        const uint8_t* row_b = row_a + (size_t)8 * a.w;
        uint32_t xa = bloom_word(a, row_a, quad_byte), xb = bloom_word(a, row_b, quad_byte);
        for (int s = 0; s < steps; ++s) {
          const uint32_t ya_lo = __byte_perm(xa, 0, 0x4140), ya_hi = __byte_perm(xa, 0, 0x4342);
          const uint32_t yb_lo = __byte_perm(xb, 0, 0x4140), yb_hi = __byte_perm(xb, 0, 0x4342);
          if (s + 1 < steps) {
            xa = bloom_word(a, row_a, quad_byte + 4 * (s + 1));
            xb = bloom_word(a, row_b, quad_byte + 4 * (s + 1));
          }
          uint32_t af[8][4];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            af[p][0] = plane_bits(ya_lo, p);
            af[p][1] = plane_bits(yb_lo, p);
            af[p][2] = plane_bits(ya_hi, p);
            af[p][3] = plane_bits(yb_hi, p);
          }
          wg_fence();
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int ks = s * 8 + p;
            const uint32_t b_addr = bq_addr + (a.kq + (ks >> 2)) * QT * 128 + (ks & 3) * 32;
            wgmma_rs<QT>(acc_k, af[p], sw128_desc(b_addr));
          }
          wg_commit();
          wg_wait_all();
        }
      }

      // f32 epilogue in the JAX operation order, into the score buffer
      const float ar0 = kKw ? a.add_row[trow + rl0] : 0.0f;
      const float ar1 = kKw ? a.add_row[trow + rl0 + 8] : 0.0f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int ql = (i >> 2) * 8 + quad * 2 + (i & 1);
        const int rl = rl0 + 8 * ((i >> 1) & 1);
        float s = acc_c[i];
        if (kKw) {
          const float kw = fminf(__fadd_rn(acc_k[i], kb[((i >> 2) << 1) | (i & 1)]), 1.0f);
          s = __fadd_rn(__fmaf_rn(kCosW, s, __fmul_rn(kKwW, kw)), (i & 2) ? ar1 : ar0);
          if (VAR == kK6) s = __fadd_rn(s, kEps);
        }
        if (VAR == kT1Cos || VAR == kT1CosKw) {
          if (tt == 0) sc[ql * SS + rl] = s;  // later tiles: computed, not kept
        } else {
          sc[ql * SS + tt * kTileRows + rl] = s;
        }
      }
    }
    consumer_sync();

    // extraction, or T1's first 128 rows: consumer warp cw owns queries
    // cw, cw + 8, ...
    for (int ql = cw; ql < QT; ql += kConsumers / 32) {
      const int qg = q0 + ql;
      if (qg >= a.b) break;  // warp-uniform; later queries are further out
      float* qs = sc + ql * SS;
      if (VAR == kK6) {
        extract_slices<true>(qs, R, a.sub, a.t1, a.packed, grow0, n_slices, qg, a.out_vals,
                             a.out_idxs, lane);
      } else if (VAR == kT1Full) {
        extract_slices<false>(qs, R, R, kT1Top, 0, grow0, a.n / R, qg, a.out_vals, nullptr,
                              lane);
      } else {
        float* o = a.out_vals + ((size_t)(grow0 / R) * a.b + qg) * kT1Wide;
        for (int e = lane; e < kT1Wide; e += 32) o[e] = qs[e];
      }
    }
    consumer_sync();
  }
}

// ---- host side ----

// a bf16 [rows, cols] row-major matrix read in [box_rows, 64] boxes with the
// 128-byte swizzle; zero fill past its edges
bool bf16_map(CUtensorMap* map, const void* ptr, long rows, long cols, int box_rows) {
  return sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, box_rows);
}

struct Launch {
  Args a;
  const void* qkw;   // bf16 [bp, 64 (kq + kk)]: queries, then permuted keyword weights
  int bp;
  int variant;
};

// the largest query tile (32, 16, 8) whose operands and scores fit; 0 if none
int pick_tile(int variant, int kq, int kk, int rows_per_group) {
  const int cols = score_cols(variant, rows_per_group);
  const int kchunks = kq + (variant == kT1Cos ? 0 : kk);
  for (int qt = kMaxQt; qt >= 8; qt /= 2)
    if (smem_bytes(qt, kchunks, 0, cols) <= (size_t)kMaxSmem) return qt;
  return 0;
}

// groups a block walks: the largest power of two (at most kMaxGroups) that
// divides the row groups and leaves at least kWaveBlocks blocks
int pick_groups(long row_groups, int q_tiles) {
  int g = 1;
  while (g * 2 <= kMaxGroups && row_groups % (g * 2) == 0 &&
         (row_groups / (g * 2)) * q_tiles >= kWaveBlocks)
    g *= 2;
  return g;
}

template <int RS, int QT, int VAR>
int launch_tile(Launch L, cudaStream_t stream) {
  Args a = L.a;
  const int kchunks = a.kq + (VAR == kT1Cos ? 0 : a.kk);
  const size_t smem = smem_bytes(QT, kchunks, 0, score_cols(VAR, a.rows_per_group));
  CUtensorMap qmap, rmap;
  if (!bf16_map(&qmap, L.qkw, L.bp, (long)kChunk * (a.kq + a.kk), QT)) return kErrTensorMap;
  if (RS == kTmaBf16) {
    if (!bf16_map(&rmap, a.emb, a.n, a.d, kTileRows)) return kErrTensorMap;
  } else {
    rmap = qmap;  // unused
  }
  const int q_tiles = (a.b + QT - 1) / QT;
  const long row_groups = a.n / a.rows_per_group;
  a.groups = pick_groups(row_groups, q_tiles);
  auto kernel = fp_scan_kernel<RS, QT, VAR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_tiles, (unsigned)(row_groups / a.groups));
  kernel<<<grid, kThreads, smem, stream>>>(qmap, rmap, a);
  return (int)cudaGetLastError();
}

template <int RS, int VAR>
int launch_rows(const Launch& L, cudaStream_t stream) {
  switch (pick_tile(VAR, L.a.kq, L.a.kk, L.a.rows_per_group)) {
    case 32: return launch_tile<RS, 32, VAR>(L, stream);
    case 16: return launch_tile<RS, 16, VAR>(L, stream);
    case 8: return launch_tile<RS, 8, VAR>(L, stream);
    default: return -1;  // no tile configuration fits this shape
  }
}

Launch make_launch(const void* emb, const void* bloom, const void* qkw, const void* kw_b,
                   const void* add_row, int n, int d, int w, int b, int bp) {
  Launch L;
  Args& a = L.a;
  a.emb = emb;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.kw_b = static_cast<const float*>(kw_b);
  a.add_row = static_cast<const float*>(add_row);
  a.out_vals = nullptr;
  a.out_idxs = nullptr;
  a.n = n; a.d = d; a.w = w; a.b = b;
  a.wp = (w + 15) / 16 * 16;
  a.kq = (d + kChunk - 1) / kChunk;
  a.kk = 8 * a.wp / kChunk;
  a.groups = 1;
  L.qkw = qkw;
  L.bp = bp;
  return L;
}

bool shape_ok(int n, int d, int w, int b, int bp) {
  return n > 0 && n % kTileRows == 0 && d > 0 && d % 4 == 0 && w > 0 && b > 0 &&
         bp >= b && bp % kMaxQt == 0;
}

}  // namespace

// K6. qkw is the wrapper's bf16 operand [bp, 64 ceil(d/64) + 8 W'] (see the
// header); sub % 128 == 0 or 128 % sub == 0.
extern "C" int omni_fp_scan_topt(const void* emb, const void* bloom, const void* qkw,
                                 const void* kw_b, const void* add_row, void* out_vals,
                                 void* out_idxs, int n, int d, int w, int b, int bp, int sub,
                                 int t1, int packed, int bf16, void* stream) {
  if (!shape_ok(n, d, w, b, bp) || sub <= 0 || t1 <= 0 || t1 > sub || n % sub != 0) return -1;
  if (sub % kTileRows != 0 && kTileRows % sub != 0) return -1;
  Launch L = make_launch(emb, bloom, qkw, kw_b, add_row, n, d, w, b, bp);
  L.a.out_vals = static_cast<float*>(out_vals);
  L.a.out_idxs = static_cast<int32_t*>(out_idxs);
  L.a.sub = sub; L.a.t1 = t1; L.a.packed = packed;
  L.a.rows_per_group = sub > kTileRows ? sub : kTileRows;
  if (n % L.a.rows_per_group != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_rows<kLoadF32, kK6>(L, st);
  return d % 8 == 0 ? launch_rows<kTmaBf16, kK6>(L, st) : launch_rows<kLoadBf16, kK6>(L, st);
}

// T1 over bf16 rows (d % 8 == 0): variant 1 cos, 2 coskw (into out
// [N/c, B, 128]), 3 full (into out [B, N/c, 9]). Blocks of c rows,
// c % 128 == 0.
extern "C" int omni_fp_scan_probe(const void* emb, const void* bloom, const void* qkw,
                                  const void* kw_b, const void* add_row, void* out, int n, int d,
                                  int w, int b, int bp, int c, int variant, void* stream) {
  if (!shape_ok(n, d, w, b, bp) || d % 8 != 0 || c <= 0 || c % kTileRows != 0 || n % c != 0)
    return -1;
  Launch L = make_launch(emb, bloom, qkw, kw_b, add_row, n, d, w, b, bp);
  L.a.out_vals = static_cast<float*>(out);
  L.a.sub = c; L.a.t1 = kT1Top; L.a.packed = 0;
  L.a.rows_per_group = c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kT1Cos: return launch_rows<kTmaBf16, kT1Cos>(L, st);
    case kT1CosKw: return launch_rows<kTmaBf16, kT1CosKw>(L, st);
    case kT1Full: return launch_rows<kTmaBf16, kT1Full>(L, st);
    default: return -1;
  }
}

// the query tile K6 (variant 0) or a T1 variant takes at extraction rows
// `rows` (K6: sub; T1: c), d and W; 0 if none fits
extern "C" int omni_fp_scan_query_tile(int variant, int rows, int d, int w) {
  const int wp = (w + 15) / 16 * 16;
  const int rows_per_group = rows > kTileRows ? rows : kTileRows;
  return pick_tile(variant, (d + kChunk - 1) / kChunk, 8 * wp / kChunk, rows_per_group);
}

extern "C" const char* omni_cuda_error_string(int code) {
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
