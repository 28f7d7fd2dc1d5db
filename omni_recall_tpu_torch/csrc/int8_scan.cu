// Hand-written Hopper (sm_90a) kernels for the int8 hybrid scans K4 and K5,
// K1's first design (with its pair mode K7a), and the profiling probes T2, T4
// and T5, on the tensor cores (wgmma, s8 in, s32 accumulators). K1 itself
// runs in csrc/int8_coarse.cu, its extraction in registers; this first
// design, its scores staged in shared memory, takes the shapes that kernel
// does not (slices under 128 rows, t1 > 9, d > 1280), and T2 and T4 are
// built on its tiles.
//
// Replaces omni_recall_tpu/ops/pallas_scorer.py:
//
//   K1  block_topt_int8_coarse: the pallas_call at :628 (body
//       _make_topt_kernel_int8_coarse_keys_t :347), its pair emit K7a (:679, body
//       _make_topt_kernel_int8_coarse :269) and its B-major keys K7b (:655); all
//       three decode to the same values, so one kernel serves them:
//         score = fma(cosd * q_scale, scale_row, add_row) + q_bias + 4e-3
//       (q_scale arrives pre-multiplied by the 0.7 cosine weight)
//   K4  block_topt_int8: the pallas_call at :824 (body _make_topt_kernel_int8 :200,
//       _ub_block_int8 :212), the certificate-miss rescue scan:
//         kw    = min(fma(kwd, 1/127, kw_b), 1)
//         score = fma(0.7, (cosd * q_scale) * scale_row, 0.2 * kw)
//               + add_row + q_bias + 4e-3
//   K5  block_topt_kw_only: the pallas_call at :519 (body
//       _make_topt_kernel_kw_only :466), the keyword-only scan of queries
//       without an embedding (no rows operand, no cosine):
//         kw    = min(fma(kwd, 1/127, kw_b), 1)
//         score = fma(0.2, kw, add_row) + 4e-3
//
// with cosd = sum_k q8[b, k] emb8[r, k] and kwd = sum_j kw_w8[b, j] bit_j(bloom[r])
// (bit j of a bloom row is bit j / W of byte j % W), then the per-slice
// top-(t1-1) + bound extraction of _extract_topt (pallas_scorer.py:105) in both
// of its modes (topt_extract.cuh), writing the decoded [B, slices, t1] contract.
//
// And the probe of the repository's tools/profile_bloomT.py (the pallas_call of
// `variant` at :39, body `kernel` :22), T5: K4's int8 body with the tool's
// epilogue, its constants folded as XLA folds them and the cosine term
// contracted (found against the interpret-mode tool body):
//         score = fma(cosd, f32(0.7 * 1e-4), kwd * f32(0.2 * f32(1/127))) + add
// and only the maximum of each 512-row slice (the bound entry of the
// two-reduce extraction at t1 = 1), values only, [B, N/512]. The bloom arrives
// as rows [N, W] or transposed [W, N] (bit j is bit j / W of byte j % W in
// both).
//
// And the two probes of K1 in the repository's tools/:
//
//   T4  tools/probe_keys_emit.py (kern_pair :123, kern_p3 :136, kern_pf :142):
//       K1's cosine with the tool's bare epilogue (no add_row, bias or eps; the
//       order found against the interpret-mode body)
//         score = (cosd * qs) * scale
//       then the packed-key rounds at any t1 (sub a power of two) and one of
//       three emits, each layout written by the kernel: pair (decoded vals +
//       global idxs) and P3 (raw packed keys) block-major [N/c, B, (c/sub) t1],
//       PF (raw keys) flat [B, (N/sub) t1].
//   T2  tools/probe_pipe.py (the pallas_call at :85, body _make_pipe_kernel :34):
//       K1's scores and extraction, each group's extraction deferred by one
//       group, so that the dot of group g overlaps the extraction of group
//       g - 1. Same scores, same rounds: the output is K1's, bit for bit.
//
// The dots sum int8 products in int32, exact in any order, and the f32
// epilogue follows the JAX graphs operation by operation (__fmaf_rn where XLA's
// compiler contracts them, one rounding per operation elsewhere; the library
// builds with -fmad=false): the output is bit for bit the plain version's.
//
// What bounds it on the H100: at the serving shapes (N = 2^20, d = 768, W = 128,
// B = 448) K1 does 2*N*d*B = 7.2e11 int8 operations over 805 MB of rows (0.365
// ms at the 1979 TOP/s int8 tensor-core peak), K4 and T5 2*N*B*(d + 8W) = 1.7e12
// over 940 MB (0.851 ms), K5 2*N*B*8W = 9.6e11 over 134 MB (0.486 ms): all
// operation-bound. K1, K4 and T5 stream every row once per query tile of QT
// queries, so their own floor is the L2-to-SM traffic: B / QT tiles x the rows'
// bytes (K1 here: 14 x 0.805 GB at QT = 32, 1.85 ms at B 448, where
// csrc/int8_coarse.cu's 128-query tile moves 3.2 GB; K4 adds the bloom
// bytes). K5 reads only the bloom bytes, B / QT times each; its floor is the
// tensor cores' own rate.
//
// Design (the shape of fp_scan.cu's K6, with int8 operands):
// - Rows are wgmma operand A (m64nQTk32.s32.s8.s8: 64 rows a consumer
//   warpgroup, two warpgroups, 128 rows a tile); the query tile is operand B
//   (N = QT = 32, 16 or 8 queries, the largest whose operands, scores and a
//   ring of three stages fit in shared memory). Both are K-major, as integer
//   wgmma requires: rows [N, d] and queries [B, d] are laid out that way.
// - A producer warpgroup (one thread issuing TMA) keeps a ring of stages full,
//   each [128 rows x 128 bytes] in the 128-byte swizzle (zero fill past d),
//   guarded by mbarriers (full: loaded; empty: both consumer warpgroups done);
//   as many stages as shared memory leaves room for, up to eight.
// - The query operand (q8, and for K4 and T5 the keyword weights) is loaded by
//   TMA once a block and stays resident (zero fill past d and past the batch).
// - The keyword dot takes operand A from registers. The wrapper permutes the
//   keyword-weight columns (ops/scorer.py int8_kw_columns) so that in k-step
//   ks = 4 v + p a thread's A bytes are bit planes 2p and 2p + 1 of its
//   v-th word of four bloom bytes, quad * W'/4 + 4 v + 0..3 (W' = W rounded up
//   to 16; bytes past W are 0): one 32-bit load a row gives four k-steps, a
//   shift and a mask each register. The bloom bytes are read once a tile,
//   with no divisions and no shared-memory staging (but for T5's transposed
//   bloom, below).
// - The scores stay on the SM: the epilogue runs on the accumulators and
//   stores f32 scores into a [QT][R + 4] shared buffer (R = max(sub, 128)
//   rows, one group of whole slices); the eight consumer warps then run the
//   extraction rounds on it (extract_slices), while the producer already loads
//   the next group's rows.
// - Registers: each kernel has its own argument struct and
//   __launch_bounds__(384, 1); the producer gives up registers (setmaxnreg.dec
//   to 40) and the consumers take them (setmaxnreg.inc to 232).
// - Launch order for L2: grid.x is the query tile, so the B / QT tiles of one
//   row block are adjacent in launch order and read its rows from device
//   memory once, from L2 after that. A block walks G groups (G a power of two,
//   at least 8 waves of blocks), so the resident operand is loaded once for
//   G * R rows.
// - K5 (kw_scan_kernel) has no rows operand to stream, so no ring and no
//   producer: four warpgroups, all consumers, take the 64-row tiles of a
//   group in turn, each running K4's keyword dot (kw_dot) against the
//   resident keyword weights (B, one TMA load a block); the shared memory K1
//   gives its ring goes to the score buffer and the weights, which allows a
//   64-query tile (wgmma N = 64) where sub <= 512. Then all 16 warps extract.
// - T5's transposed bloom [W, N] holds a row's bytes N apart. Each consumer
//   warpgroup stages its 64 rows of a tile into shared memory as rows
//   [64][W + 4]: 32-bit loads along the rows (started before the cosine dot),
//   a 4 x 4 byte transpose in registers (__byte_perm), one 32-bit store a
//   row; then its threads read their words as the row layout does, so the
//   operand, and the column order, are the row layout's.
// - T4 is int8_scan_kernel with KeysArgs: K1's tiles, the bare epilogue and
//   the emit's layout (extract_slices with topt_extract.cuh's EMIT and
//   Offset).
// - T2 (int8_pipe_kernel) is K1 with two more warpgroups that only extract:
//   K1's producer and two wgmma consumer warpgroups score group g into score
//   slot g % 2 while the extraction warpgroups run group g - 1's rounds from
//   the other slot (eight warps, as many as K1 extracts with; four fell
//   behind the dot at t1 = 5); the slots change hands at named barriers.
//   640 threads get 96 registers each at launch, split 40 / 128 / 128 / 88 /
//   88 by setmaxnreg. Two [QT][R + 4] slots halve the query tile where one
//   slot took most of the shared memory (QT 16 at sub 1024, d 768), and each
//   row is then read from L2 twice as often.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "topt_extract.cuh"

namespace {

using namespace omni;

constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kThreads = 3 * kWg;         // producer warpgroup + two consumers
constexpr int kConsumers = 2 * kWg;
constexpr int kMaxSmem = 232448;
constexpr int kTileRows = 128;            // rows of a stage: 64 per consumer warpgroup
constexpr int kChunk = 128;               // K bytes of a stage: one 128-byte swizzle atom
constexpr int kStageBytes = kTileRows * kChunk;
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kScorePad = 4;              // floats of padding per score row
constexpr int kWaveBlocks = 132 * 8;      // at least this many blocks, where the rows allow
constexpr int kMaxGroups = 64;            // groups a block walks at most
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kKwWords = 8;               // bloom words of a row a thread holds at once
constexpr float kEpsInt8 = 4e-3f;         // PALLAS_CERT_EPS_INT8
constexpr float kCosW = 0.7f;             // COSINE_WEIGHT
constexpr float kKwW = 0.2f;              // KEYWORD_WEIGHT
constexpr float kInv127 = (float)(1.0 / 127.0);
// T5's constants, each folded to one f32 as XLA folds the tool's graph
constexpr float kProbeCos = kCosW * 1e-4f;
constexpr float kProbeKw = kKwW * kInv127;
constexpr int kProbeSlice = 512;          // rows whose maximum T5 keeps
constexpr int kKwTileRows = 64;           // K5: rows of a tile, one warpgroup's
constexpr int kKwWarpgroups = 4;          // K5: warpgroups a block, all consumers
constexpr int kPipeExtractors = 2 * kWg;  // T2: threads of the extraction warpgroups
constexpr int kPipeThreads = kWg + kConsumers + kPipeExtractors;  // T2: 640
constexpr int kPipeConsumerRegs = 128;    // T2's split of the 96 x 640 registers:
constexpr int kPipeExtractorRegs = 88;    // 40 + 2 * 128 + 2 * 88 = 472 <= 480
constexpr int kPipeHandover = kConsumers + kPipeExtractors;  // threads at a slot's hand-over

enum KeysEmit : int { kEmitPair = 0, kEmitP3 = 1, kEmitPF = 2 };  // T4's emits

// K1's arguments
struct CoarseArgs {
  static constexpr bool kKw = false;
  static constexpr bool kProbe = false;
  static constexpr bool kKeys = false;
  const float* add_row;   // [n]
  const float* scale_row; // [n]
  const float* q_scale;   // [b], 0.7 folded in
  const float* q_bias;    // [b]
  float* out_vals;
  int32_t* out_idxs;
  int n, b, sub, t1, packed;
  int kq;                 // 128-byte K chunks of the rows and queries
  int rows_per_group;     // R: whole slices
  int groups;             // G: groups a block walks
  int stages;             // ring stages
};

// K4's arguments: K1's and the keyword operands
struct FusedArgs : CoarseArgs {
  static constexpr bool kKw = true;
  const uint8_t* bloom;   // [n, w]
  const float* kw_b;      // [b]
  int w;
  int wp;                 // w rounded up to 16
  int kk;                 // 128-byte K chunks of the keyword operand (wp / 16)
};

// T5's arguments: K4's operands less scale_row, q_scale, q_bias, kw_b and
// out_idxs (unused), the bloom [n, w] or, transposed, [w, n]; w % 16 == 0
struct ProbeArgs : FusedArgs {
  static constexpr bool kProbe = true;
  int transposed;
};

// T4's arguments: K1's tiles with the bare epilogue (the tool's scale and
// qs) and the emit's layout; the rounds are always the packed ones
struct KeysArgs {
  static constexpr bool kKw = false;
  static constexpr bool kProbe = false;
  static constexpr bool kKeys = true;
  const float* scale_row; // [n] the tool's scale
  const float* q_scale;   // [b] the tool's qs
  float* out_vals;        // pair: decoded values (else unused)
  int32_t* out_idxs;      // pair: global row indices; P3, PF: the packed keys
  int n, b, sub, t1;
  int kq;                 // 128-byte K chunks of the rows and queries
  int rows_per_group;     // R: whole slices
  int groups;             // G: groups a block walks
  int stages;             // ring stages
  int emit;               // KeysEmit
  int n_sub;              // slices of the tool's block of c rows (c / sub)
};

// T2's arguments: K1's, and the row groups of the whole scan (the last
// block walks what is left of them)
struct PipeArgs : CoarseArgs {
  int row_groups;         // n / rows_per_group
};

// K5's arguments: no rows, no cosine terms
struct KwOnlyArgs {
  static constexpr bool kProbe = false;
  const uint8_t* bloom;   // [n, w]
  const float* kw_b;      // [b]
  const float* add_row;   // [n]
  float* out_vals;
  int32_t* out_idxs;
  int n, b, sub, t1, packed;
  int w;
  int wp;                 // w rounded up to 16
  int kk;                 // 128-byte K chunks of the keyword operand (wp / 16)
  int rows_per_group;     // R: whole slices
  int groups;             // G: groups a block walks
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// D[64 x N] += A[64 x 32] * B[32 x N] in s8 x s8 -> s32: A from shared memory
// (ss) or registers (rs), B from shared memory
template <int N>
__device__ void wgmma_ss(int (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ void wgmma_rs(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<8>(int (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3 "
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// K5's 64-query tile (register A only)
template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// bit plane k of four bloom bytes: four 0/1 int8 lanes
__device__ __forceinline__ uint32_t plane(uint32_t x, int k) { return (x >> k) & 0x01010101u; }

// the four bloom bytes byte0 .. byte0 + 3 of one row (0 past W)
template <class A>
__device__ __forceinline__ uint32_t bloom_word(const A& a, const uint8_t* row, int byte0) {
  if ((a.w & 15) == 0) return __ldg(reinterpret_cast<const uint32_t*>(row + byte0));
  uint32_t x = 0;
#pragma unroll
  for (int o = 0; o < 4; ++o)
    if (byte0 + o < a.w) x |= static_cast<uint32_t>(__ldg(row + byte0 + o)) << (8 * o);
  return x;
}

// a thread's next kKwWords bloom words of one row, from byte0 on (`words` of
// them are inside W'; the rest 0): two 16-byte loads where W % 64 == 0
template <class A>
__device__ __forceinline__ void bloom_words(const A& a, const uint8_t* row, int byte0,
                                            int words, uint32_t (&x)[kKwWords]) {
  if ((a.w & 63) == 0 && words >= kKwWords) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(row + byte0));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(row + byte0 + 16));
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kKwWords; ++j) x[j] = j < words ? bloom_word(a, row, byte0 + 4 * j) : 0u;
}

// T5's transposed bloom [w, n] (w % 16 == 0), staged a warpgroup at a time:
// unit u of a warpgroup's 64 rows from r0 is bytes 4 (u / 16) .. + 3 of rows
// 4 (u % 16) .. + 3, four 32-bit loads along the rows (a warp reads two
// 64-byte runs a load); thread t fetches units t, t + 128, ... (the first
// kStageUnits into registers before the cosine dot, any more after it)
constexpr int kStageUnits = 4;  // all of a thread's units where W <= 128

template <class A>
__device__ __forceinline__ void fetch_unit(const A& a, long r0, int u, uint32_t (&x)[4]) {
  const uint8_t* p = a.bloom + (size_t)(4 * (u >> 4)) * a.n + r0 + 4 * (u & 15);
#pragma unroll
  for (int o = 0; o < 4; ++o) x[o] = __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)o * a.n));
}

// a unit's 4 x 4 bytes transposed (x[o] byte i is byte o of row i) into the
// staged rows [64][stride]: row i gets one 32-bit word
__device__ __forceinline__ void store_unit(unsigned char* rows, int stride, int u,
                                           const uint32_t (&x)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140), t3 = __byte_perm(x[2], x[3], 0x7362);
  unsigned char* p = rows + (size_t)(4 * (u & 15)) * stride + 4 * (u >> 4);
  *reinterpret_cast<uint32_t*>(p) = __byte_perm(t0, t2, 0x5410);
  *reinterpret_cast<uint32_t*>(p + stride) = __byte_perm(t0, t2, 0x7632);
  *reinterpret_cast<uint32_t*>(p + 2 * stride) = __byte_perm(t1, t3, 0x5410);
  *reinterpret_cast<uint32_t*>(p + 3 * stride) = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWg) : "memory");
}

// a row's bloom words: from the bloom rows in global memory, or (T5's
// transposed bloom) from the warpgroup's staged rows in shared memory
template <class A>
__device__ __forceinline__ void row_words(const A& a, const uint8_t* row, int byte0, int words,
                                          uint32_t (&x)[kKwWords]) {
  if constexpr (A::kProbe) {
    if (a.transposed) {
#pragma unroll
      for (int j = 0; j < kKwWords; ++j)
        x[j] = j < words ? *reinterpret_cast<const uint32_t*>(row + byte0 + 4 * j) : 0u;
      return;
    }
  }
  bloom_words(a, row, byte0, words, x);
}

// The keyword dot of K4, T5 and K5 over a warpgroup's 64 rows: A = bit
// planes of the bloom words of the thread's two rows (row_a, row_b, from
// byte0) in registers, B = the resident keyword weights in int8_kw_columns
// order, word v at chunk b0 + v * QT * 128 bytes. xa and xb hold the first
// kKwWords words on entry (loaded early, to be in flight meanwhile).
template <int QT, class A>
__device__ __forceinline__ void kw_dot(const A& a, int (&acc)[QT / 2], const uint8_t* row_a,
                                       const uint8_t* row_b, int byte0, int words, uint32_t b0,
                                       uint32_t (&xa)[kKwWords], uint32_t (&xb)[kKwWords]) {
  for (int v0 = 0; v0 < words; v0 += kKwWords) {
    if (v0 > 0) {
      row_words(a, row_a, byte0 + 4 * v0, words - v0, xa);
      row_words(a, row_b, byte0 + 4 * v0, words - v0, xb);
    }
#pragma unroll
    for (int j = 0; j < kKwWords; j += 2) {
      if (v0 + j >= words) break;
      uint32_t af[8][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          af[4 * u + p][0] = plane(xa[j + u], 2 * p);
          af[4 * u + p][1] = plane(xb[j + u], 2 * p);
          af[4 * u + p][2] = plane(xa[j + u], 2 * p + 1);
          af[4 * u + p][3] = plane(xb[j + u], 2 * p + 1);
        }
      wg_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (v0 + j + u < words) {
          const uint32_t b_addr = b0 + (v0 + j + u) * QT * kChunk;
#pragma unroll
          for (int p = 0; p < 4; ++p) wgmma_rs<QT>(acc, af[4 * u + p], sw128_desc(b_addr + p * 32));
        }
      }
      wg_commit();
      wg_wait_all();
    }
  }
}

// T4: one query's packed-key rounds over a group, written in the emit's
// layout (pair and P3 block-major, PF the contract's own layout, flat)
__device__ __forceinline__ void extract_emit(const KeysArgs& a, float* sc, int R, long row0,
                                             long n_slices, int qg, int lane) {
  const BlockMajor blocks{a.b, a.n_sub};
  if (a.emit == kEmitPair)
    extract_slices<true>(sc, R, a.sub, a.t1, 1, row0, n_slices, qg, a.out_vals, a.out_idxs,
                         lane, blocks);
  else if (a.emit == kEmitP3)
    extract_slices<false, kRawKeys>(sc, R, a.sub, a.t1, 1, row0, n_slices, qg, nullptr,
                                    a.out_idxs, lane, blocks);
  else
    extract_slices<false, kRawKeys>(sc, R, a.sub, a.t1, 1, row0, n_slices, qg, nullptr,
                                    a.out_idxs, lane);
}

constexpr size_t smem_bytes(int qt, int kchunks, int stages, int rows, size_t staged = 0) {
  return 1024 + (size_t)qt * kChunk * kchunks + (size_t)stages * kStageBytes +
         (size_t)qt * (rows + kScorePad) * 4 + (2 * stages + 1) * 8 + staged;
}

template <int QT, class A>
__global__ void __launch_bounds__(kThreads, 1)
    int8_scan_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap rmap, const A a) {
  constexpr bool kKw = A::kKw;
  constexpr int NACC = QT / 2;  // accumulator registers a thread, per dot
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int kk = 0;
  if constexpr (kKw) kk = a.kk;
  const int kchunks = a.kq + kk;
  unsigned char* bq = sm;                                  // [kchunks][QT][128 B]
  unsigned char* ring = bq + (size_t)QT * kChunk * kchunks;  // [stages][128 rows][128 B]
  float* sc = reinterpret_cast<float*>(ring + (size_t)a.stages * kStageBytes);
  const int R = a.rows_per_group;
  const int SS = R + kScorePad;                            // score row stride
  uint64_t* bars = reinterpret_cast<uint64_t*>(sc + (size_t)QT * SS);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + a.stages);
  const uint32_t bq_full = smem_u32(bars + 2 * a.stages);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const long row_base = (long)blockIdx.y * a.groups * R;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(bq_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bq_full, (uint32_t)(QT * kChunk * kchunks));
      for (int c = 0; c < a.kq; ++c)
        tma_load_2d(smem_u32(bq + (size_t)c * QT * kChunk), &qmap, c * kChunk, q0, bq_full);
      for (int c = 0; c < kk; ++c)
        tma_load_2d(smem_u32(bq + (size_t)(a.kq + c) * QT * kChunk), &kmap, c * kChunk, q0,
                    bq_full);
      int stage = 0;
      uint32_t phase = 0;
      const int tiles = a.groups * (R / kTileRows);
      for (int t = 0; t < tiles; ++t) {
        const int row0 = (int)(row_base + (long)t * kTileRows);
        for (int kc = 0; kc < a.kq; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, kStageBytes);
          tma_load_2d(smem_u32(ring + (size_t)stage * kStageBytes), &rmap, kc * kChunk, row0,
                      full0 + 8 * stage);
          if (++stage == a.stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ctid = tid - kWg, cw = ctid >> 5, lane = tid & 31;
    const int g = cw >> 2;                                  // which 64 rows of a tile
    const int rl0 = g * 64 + (cw & 3) * 16 + (lane >> 2);   // accumulator rows rl0, rl0 + 8
    const int quad = lane & 3;
    const uint32_t bq_addr = smem_u32(bq), ring_addr = smem_u32(ring);
    // T5's transposed bloom: this warpgroup's staged rows, after the barriers
    bool transposed = false;
    unsigned char* staged = nullptr;
    if constexpr (A::kProbe) {
      transposed = a.transposed;
      staged = reinterpret_cast<unsigned char*>(bars + 2 * a.stages + 1) +
               (size_t)g * 64 * (a.w + 4);
    }

    // per-query terms of the thread's queries (j8 * 8 + quad * 2 + h); T5
    // has none, T4 its qs alone
    float qsc[NACC / 2], qb[NACC / 2], kb[NACC / 2];
#pragma unroll
    for (int i = 0; i < NACC / 2; ++i) {
      const int qg = q0 + (i >> 1) * 8 + quad * 2 + (i & 1);
      const bool ok = qg < a.b && !A::kProbe;
      qsc[i] = ok ? a.q_scale[qg] : 0.0f;
      qb[i] = 0.0f;
      if constexpr (!A::kKeys) qb[i] = ok ? a.q_bias[qg] : 0.0f;
      kb[i] = 0.0f;
      if constexpr (kKw) kb[i] = ok ? a.kw_b[qg] : 0.0f;
    }
    mbar_wait(bq_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    const long n_slices = a.n / a.sub;
    for (int grp = 0; grp < a.groups; ++grp) {
      const long grow0 = row_base + (long)grp * R;
      for (int tt = 0; tt < R / kTileRows; ++tt) {
        const long trow = grow0 + (long)tt * kTileRows;
        float ar0 = 0.0f, ar1 = 0.0f;
        if constexpr (!A::kKeys) ar0 = a.add_row[trow + rl0], ar1 = a.add_row[trow + rl0 + 8];
        float sr0 = 0.0f, sr1 = 0.0f;
        if constexpr (!A::kProbe) sr0 = a.scale_row[trow + rl0], sr1 = a.scale_row[trow + rl0 + 8];
        int acc_c[NACC], acc_k[NACC];
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc_c[i] = acc_k[i] = 0;

        // K4: the thread's first bloom words of its two rows, in flight
        // during the cosine dot (T5's transposed bloom: its units of the
        // warpgroup's rows)
        const uint8_t* row_a = nullptr;
        const uint8_t* row_b = nullptr;
        int words = 0, byte0 = 0;
        uint32_t xa[kKwWords], xb[kKwWords], tb[kStageUnits][4];
        if constexpr (kKw) {
          words = a.wp >> 4;
          byte0 = quad * (a.wp >> 2);
          if (transposed) {
            row_a = staged + (size_t)(rl0 - 64 * g) * (a.w + 4);
            row_b = row_a + (size_t)8 * (a.w + 4);
#pragma unroll
            for (int k = 0; k < kStageUnits; ++k)
              if (ctid % kWg + kWg * k < 4 * a.w)
                fetch_unit(a, trow + 64 * g, ctid % kWg + kWg * k, tb[k]);
          } else {
            row_a = a.bloom + (size_t)(trow + rl0) * a.w;
            row_b = row_a + (size_t)8 * a.w;
            bloom_words(a, row_a, byte0, words, xa);
            bloom_words(a, row_b, byte0, words, xb);
          }
        }

        // cosine: A = the stage's rows, B = the resident queries; a stage
        // goes back to the producer as soon as its wgmmas are done
        for (int kc = 0; kc < a.kq; ++kc) {
          mbar_wait(full0 + 8 * stage, phase);
          wg_fence();
          const uint32_t a_addr = ring_addr + stage * kStageBytes + g * 64 * kChunk;
          const uint32_t b_addr = bq_addr + kc * QT * kChunk;
#pragma unroll
          for (int ks = 0; ks < kChunk / 32; ++ks)
            wgmma_ss<QT>(acc_c, sw128_desc(a_addr + ks * 32), sw128_desc(b_addr + ks * 32));
          wg_commit();
          wg_wait_all();
          mbar_arrive(empty0 + 8 * stage);
          if (++stage == a.stages) { stage = 0; phase ^= 1; }
        }

        // keyword: A = bit planes of the bloom words in registers, B = the
        // resident (permuted) keyword weights; word v is B's chunk kq + v
        if constexpr (kKw) {
          // T5's transposed bloom: the warpgroup stages its rows (once the
          // previous tile's are read), then each thread reads its words
          if (transposed) {
            wg_bar(2 + g);
#pragma unroll
            for (int k = 0; k < kStageUnits; ++k)
              if (ctid % kWg + kWg * k < 4 * a.w)
                store_unit(staged, a.w + 4, ctid % kWg + kWg * k, tb[k]);
            for (int u = ctid % kWg + kWg * kStageUnits; u < 4 * a.w; u += kWg) {
              uint32_t x[4];
              fetch_unit(a, trow + 64 * g, u, x);
              store_unit(staged, a.w + 4, u, x);
            }
            wg_bar(2 + g);
            row_words(a, row_a, byte0, words, xa);
            row_words(a, row_b, byte0, words, xb);
          }
          kw_dot<QT>(a, acc_k, row_a, row_b, byte0, words, bq_addr + a.kq * QT * kChunk, xa, xb);
        }

        // f32 epilogue in the JAX operation order, into the score buffer
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int ql = (i >> 2) * 8 + quad * 2 + (i & 1);
          const int rl = rl0 + 8 * ((i >> 1) & 1);
          const int j = ((i >> 2) << 1) | (i & 1);
          const float ar = (i & 2) ? ar1 : ar0, sr = (i & 2) ? sr1 : sr0;
          float s;
          if constexpr (A::kKeys) {
            s = __fmul_rn(__fmul_rn((float)acc_c[i], qsc[j]), sr);
          } else if constexpr (A::kProbe) {
            s = __fmaf_rn((float)acc_c[i], kProbeCos, __fmul_rn((float)acc_k[i], kProbeKw));
            s = __fadd_rn(s, ar);
          } else if constexpr (kKw) {
            const float kw = fminf(__fmaf_rn((float)acc_k[i], kInv127, kb[j]), 1.0f);
            const float cos = __fmul_rn(__fmul_rn((float)acc_c[i], qsc[j]), sr);
            s = __fmaf_rn(kCosW, cos, __fmul_rn(kKwW, kw));
            s = __fadd_rn(__fadd_rn(__fadd_rn(s, ar), qb[j]), kEpsInt8);
          } else {
            s = __fmaf_rn(__fmul_rn((float)acc_c[i], qsc[j]), sr, ar);
            s = __fadd_rn(__fadd_rn(s, qb[j]), kEpsInt8);
          }
          sc[ql * SS + tt * kTileRows + rl] = s;
        }
      }
      consumer_sync();

      // extraction: consumer warp cw owns queries cw, cw + 8, ...
      for (int ql = cw; ql < QT; ql += kConsumers / 32) {
        const int qg = q0 + ql;
        if (qg >= a.b) break;  // warp-uniform; later queries are further out
        if constexpr (A::kKeys)
          extract_emit(a, sc + ql * SS, R, grow0, n_slices, qg, lane);
        else
          extract_slices<!A::kProbe>(sc + ql * SS, R, a.sub, a.t1, a.packed, grow0, n_slices,
                                     qg, a.out_vals, a.out_idxs, lane);
      }
      consumer_sync();
    }
  }
}


// ---- T2: K1 with its extraction deferred one group ----

// named barriers of T2's slot hand-over (0 is __syncthreads'), one per slot:
// "full" (the consumers arrive, the extractor waits) and "free" (the other
// way round)
constexpr int kBarFull = 1, kBarFree = 3;

__device__ __forceinline__ void bar_sync_n(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive_n(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr size_t pipe_smem_bytes(int qt, int kq, int stages, int rows) {
  return 1024 + (size_t)qt * kChunk * kq + (size_t)stages * kStageBytes +
         2 * (size_t)qt * (rows + kScorePad) * 4 + (2 * stages + 1) * 8;
}

// Warpgroup 0 is K1's producer, 1 and 2 K1's consumers, which score group g
// into slot g % 2; warpgroups 3 and 4 extract group g - 1 from the other slot
// (warp w of theirs: queries w, w + 8, ...). A slot is handed to the
// extractors once both consumer warpgroups stored the group's scores
// (bar.arrive by the consumers, bar.sync by the extractors), and back once
// its rounds are done, if a later group is to be scored into it. Every
// thread passes every hand-over of its side, whatever its queries.
template <int QT>
__global__ void __launch_bounds__(kPipeThreads, 1)
    int8_pipe_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap rmap, const PipeArgs a) {
  constexpr int NACC = QT / 2;  // accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bq = sm;                                 // [kq][QT][128 B]
  unsigned char* ring = bq + (size_t)QT * kChunk * a.kq;  // [stages][128 rows][128 B]
  float* slots = reinterpret_cast<float*>(ring + (size_t)a.stages * kStageBytes);
  const int R = a.rows_per_group;
  const int SS = R + kScorePad;                           // score row stride
  const size_t slot_floats = (size_t)QT * SS;             // [2][QT][SS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + 2 * slot_floats);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + a.stages);
  const uint32_t bq_full = smem_u32(bars + 2 * a.stages);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int groups = min(a.groups, a.row_groups - (int)blockIdx.y * a.groups);
  const long row_base = (long)blockIdx.y * a.groups * R;
  const long n_slices = a.n / a.sub;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(bq_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer warpgroup: K1's ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bq_full, (uint32_t)(QT * kChunk * a.kq));
      for (int c = 0; c < a.kq; ++c)
        tma_load_2d(smem_u32(bq + (size_t)c * QT * kChunk), &qmap, c * kChunk, q0, bq_full);
      int stage = 0;
      uint32_t phase = 0;
      const int tiles = groups * (R / kTileRows);
      for (int t = 0; t < tiles; ++t) {
        const int row0 = (int)(row_base + (long)t * kTileRows);
        for (int kc = 0; kc < a.kq; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, kStageBytes);
          tma_load_2d(smem_u32(ring + (size_t)stage * kStageBytes), &rmap, kc * kChunk, row0,
                      full0 + 8 * stage);
          if (++stage == a.stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else if (tid < kWg + kConsumers) {
    // ---- consumer warpgroups: K1's dot and epilogue, into slot grp % 2 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kPipeConsumerRegs));
    const int ctid = tid - kWg, cw = ctid >> 5, lane = tid & 31;
    const int g = cw >> 2;                                  // which 64 rows of a tile
    const int rl0 = g * 64 + (cw & 3) * 16 + (lane >> 2);   // accumulator rows rl0, rl0 + 8
    const int quad = lane & 3;
    const uint32_t bq_addr = smem_u32(bq), ring_addr = smem_u32(ring);
    float qsc[NACC / 2], qb[NACC / 2];
#pragma unroll
    for (int i = 0; i < NACC / 2; ++i) {
      const int qg = q0 + (i >> 1) * 8 + quad * 2 + (i & 1);
      qsc[i] = qg < a.b ? a.q_scale[qg] : 0.0f;
      qb[i] = qg < a.b ? a.q_bias[qg] : 0.0f;
    }
    mbar_wait(bq_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int grp = 0; grp < groups; ++grp) {
      float* sc = slots + (grp & 1) * slot_floats;
      if (grp >= 2) bar_sync_n(kBarFree + (grp & 1), kPipeHandover);  // group grp - 2 is out
      const long grow0 = row_base + (long)grp * R;
      for (int tt = 0; tt < R / kTileRows; ++tt) {
        const long trow = grow0 + (long)tt * kTileRows;
        const float ar0 = a.add_row[trow + rl0], ar1 = a.add_row[trow + rl0 + 8];
        const float sr0 = a.scale_row[trow + rl0], sr1 = a.scale_row[trow + rl0 + 8];
        int acc[NACC];
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0;
        for (int kc = 0; kc < a.kq; ++kc) {
          mbar_wait(full0 + 8 * stage, phase);
          wg_fence();
          const uint32_t a_addr = ring_addr + stage * kStageBytes + g * 64 * kChunk;
          const uint32_t b_addr = bq_addr + kc * QT * kChunk;
#pragma unroll
          for (int ks = 0; ks < kChunk / 32; ++ks)
            wgmma_ss<QT>(acc, sw128_desc(a_addr + ks * 32), sw128_desc(b_addr + ks * 32));
          wg_commit();
          wg_wait_all();
          mbar_arrive(empty0 + 8 * stage);
          if (++stage == a.stages) { stage = 0; phase ^= 1; }
        }
        // K1's epilogue, in its operation order
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int ql = (i >> 2) * 8 + quad * 2 + (i & 1);
          const int rl = rl0 + 8 * ((i >> 1) & 1);
          const int j = ((i >> 2) << 1) | (i & 1);
          float s = __fmaf_rn(__fmul_rn((float)acc[i], qsc[j]), (i & 2) ? sr1 : sr0,
                              (i & 2) ? ar1 : ar0);
          sc[ql * SS + tt * kTileRows + rl] = __fadd_rn(__fadd_rn(s, qb[j]), kEpsInt8);
        }
      }
      bar_arrive_n(kBarFull + (grp & 1), kPipeHandover);  // slot grp % 2 holds group grp
    }
  } else {
    // ---- extraction warpgroups: group grp's rounds, one group behind ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPipeExtractorRegs));
    const int ew = (tid - kWg - kConsumers) >> 5, lane = tid & 31;
    for (int grp = 0; grp < groups; ++grp) {
      float* sc = slots + (grp & 1) * slot_floats;
      bar_sync_n(kBarFull + (grp & 1), kPipeHandover);
      const long grow0 = row_base + (long)grp * R;
      for (int ql = ew; ql < QT; ql += kPipeExtractors / 32) {
        const int qg = q0 + ql;
        if (qg >= a.b) break;  // warp-uniform; later queries are further out
        extract_slices<true>(sc + ql * SS, R, a.sub, a.t1, a.packed, grow0, n_slices, qg,
                             a.out_vals, a.out_idxs, lane);
      }
      // hand the slot back only if a group is still to be scored into it
      if (grp + 2 < groups) bar_arrive_n(kBarFree + (grp & 1), kPipeHandover);
    }
  }
}

// K5: kKwWarpgroups warpgroups, all consumers. Thread 0 loads the resident
// keyword weights (operand B, [kk][QT][128 B]) by TMA; warpgroup wg takes the
// 64-row tiles wg, wg + 4, ... of each group of R rows, runs the keyword dot
// (kw_dot) and stores the epilogue's scores into the [QT][R + 4] buffer;
// then every warp extracts queries warp, warp + 16, ... The 512 threads get
// 128 registers each, so the row indices are 32-bit (n < 2^31) and at QT 64
// the tile's kw_b is read from shared memory (in registers it would spill).
template <int QT>
__global__ void __launch_bounds__(kKwWarpgroups * kWg, 1)
    kw_scan_kernel(const __grid_constant__ CUtensorMap kmap, const KwOnlyArgs a) {
  constexpr int NACC = QT / 2;  // accumulator registers a thread
  constexpr int kWarps = kKwWarpgroups * 4;
  constexpr bool kKbRegs = QT < 64;  // kw_b in registers (else the shared copy)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bk = sm;  // [kk][QT][128 B]
  float* sc = reinterpret_cast<float*>(bk + (size_t)QT * kChunk * a.kk);
  const int R = a.rows_per_group;
  const int SS = R + kScorePad;  // score row stride
  uint64_t* bar = reinterpret_cast<uint64_t*>(sc + (size_t)QT * SS);
  float* kb = reinterpret_cast<float*>(bar + 1);  // [QT] kw_b of the tile's queries (QT 64)
  const uint32_t bk_full = smem_u32(bar);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int wg = warp >> 2;
  const int rl0 = (warp & 3) * 16 + (lane >> 2);  // accumulator rows rl0, rl0 + 8 of a tile
  const int q0 = blockIdx.x * QT;
  const int row_base = blockIdx.y * a.groups * R;

  if (tid == 0) {
    mbar_init(bk_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kKbRegs && tid < QT) kb[tid] = q0 + tid < a.b ? a.kw_b[q0 + tid] : 0.0f;
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bk_full, (uint32_t)(QT * kChunk * a.kk));
    for (int c = 0; c < a.kk; ++c)
      tma_load_2d(smem_u32(bk + (size_t)c * QT * kChunk), &kmap, c * kChunk, q0, bk_full);
  }

  // kw_b of the thread's queries (j8 * 8 + quad * 2 + h)
  float kbr[kKbRegs ? NACC / 2 : 1];
  if constexpr (kKbRegs) {
#pragma unroll
    for (int i = 0; i < NACC / 2; ++i) {
      const int qg = q0 + (i >> 1) * 8 + quad * 2 + (i & 1);
      kbr[i] = qg < a.b ? a.kw_b[qg] : 0.0f;
    }
  }
  const int words = a.wp >> 4, byte0 = quad * (a.wp >> 2);
  const uint32_t bk_addr = smem_u32(bk);
  mbar_wait(bk_full, 0);

  const int n_slices = a.n / a.sub;
  for (int grp = 0; grp < a.groups; ++grp) {
    const int grow0 = row_base + grp * R;
    for (int tt = wg; tt < R / kKwTileRows; tt += kKwWarpgroups) {
      const int trow = grow0 + tt * kKwTileRows;
      const uint8_t* row_a = a.bloom + (size_t)(trow + rl0) * a.w;
      const uint8_t* row_b = row_a + (size_t)8 * a.w;
      const float ar0 = a.add_row[trow + rl0], ar1 = a.add_row[trow + rl0 + 8];
      int acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0;

      uint32_t xa[kKwWords], xb[kKwWords];
      bloom_words(a, row_a, byte0, words, xa);
      bloom_words(a, row_b, byte0, words, xb);
      kw_dot<QT>(a, acc, row_a, row_b, byte0, words, bk_addr, xa, xb);

      // f32 epilogue in the JAX operation order, into the score buffer
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int ql = (i >> 2) * 8 + quad * 2 + (i & 1);
        const int rl = rl0 + 8 * ((i >> 1) & 1);
        float kbq;
        if constexpr (kKbRegs) kbq = kbr[((i >> 2) << 1) | (i & 1)];
        else kbq = kb[ql];
        const float kw = fminf(__fmaf_rn((float)acc[i], kInv127, kbq), 1.0f);
        sc[ql * SS + tt * kKwTileRows + rl] =
            __fadd_rn(__fmaf_rn(kKwW, kw, (i & 2) ? ar1 : ar0), kEpsInt8);
      }
    }
    __syncthreads();

    // extraction: warp w owns queries w, w + 16, ...
    for (int ql = warp; ql < QT; ql += kWarps) {
      const int qg = q0 + ql;
      if (qg >= a.b) break;  // warp-uniform; later queries are further out
      extract_slices<true>(sc + ql * SS, R, a.sub, a.t1, a.packed, grow0, n_slices, qg,
                           a.out_vals, a.out_idxs, lane);
    }
    __syncthreads();
  }
}

// ---- host side ----

// the largest query tile (32, 16, 8) whose operands, scores, a ring of
// kMinStages stages and `staged` bytes (T5's transposed bloom) fit; 0 if none
int pick_tile(int kchunks, int rows, size_t staged = 0) {
  for (int qt = 32; qt >= 8; qt /= 2)
    if (smem_bytes(qt, kchunks, kMinStages, rows, staged) <= (size_t)kMaxSmem) return qt;
  return 0;
}

// ring stages: as many as fit beside the tile, up to kMaxStages
int pick_stages(int qt, int kchunks, int rows, size_t staged = 0) {
  int s = kMinStages;
  while (s < kMaxStages && smem_bytes(qt, kchunks, s + 1, rows, staged) <= (size_t)kMaxSmem) ++s;
  return s;
}

// shared memory for T5's staged rows of the transposed bloom: two
// warpgroups' 64 rows, each W bytes and 4 of padding (conflict-free 32-bit
// reads); none for the other kernels
template <class A>
size_t staged_bytes(const A& a) {
  if constexpr (A::kProbe) return a.transposed ? (size_t)2 * 64 * (a.w + 4) : 0;
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

bool uint8_map(CUtensorMap* map, const void* ptr, long rows, long cols, int box_rows) {
  return sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, cols, box_rows);
}

// the operands' global layouts: rows i8 [n, d], queries i8 [b, d], and K4's
// permuted keyword weights i8 [b, 8 wp]
struct Operands {
  const void* emb8;
  const void* q8;
  const void* kw8;
  int d;
};

template <int QT, class A>
int launch_tile(A a, const Operands& o, cudaStream_t stream) {
  int kk = 0;
  if constexpr (A::kKw) kk = a.kk;
  const int kchunks = a.kq + kk;
  CUtensorMap qmap, kmap, rmap;
  if (!uint8_map(&qmap, o.q8, a.b, o.d, QT)) return kErrTensorMap;
  if (!uint8_map(&rmap, o.emb8, a.n, o.d, kTileRows)) return kErrTensorMap;
  kmap = qmap;  // K1: unused
  if (kk && !uint8_map(&kmap, o.kw8, a.b, (long)kChunk * kk, QT)) return kErrTensorMap;
  const size_t staged = staged_bytes(a);
  a.stages = pick_stages(QT, kchunks, a.rows_per_group, staged);
  const size_t smem = smem_bytes(QT, kchunks, a.stages, a.rows_per_group, staged);
  const int q_tiles = (a.b + QT - 1) / QT;
  const long row_groups = a.n / a.rows_per_group;
  a.groups = pick_groups(row_groups, q_tiles);
  if (row_groups / a.groups > 65535) return -1;
  auto kernel = int8_scan_kernel<QT, A>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_tiles, (unsigned)(row_groups / a.groups));
  kernel<<<grid, kThreads, smem, stream>>>(qmap, kmap, rmap, a);
  return (int)cudaGetLastError();
}

template <class A>
int launch(const A& a, int kchunks, const Operands& o, cudaStream_t stream) {
  switch (pick_tile(kchunks, a.rows_per_group, staged_bytes(a))) {
    case 32: return launch_tile<32>(a, o, stream);
    case 16: return launch_tile<16>(a, o, stream);
    case 8: return launch_tile<8>(a, o, stream);
    default: return -1;  // no tile configuration fits this shape
  }
}

// ---- K5 ----

constexpr size_t kw_smem_bytes(int qt, int kk, int rows) {
  return 1024 + (size_t)qt * kChunk * kk + (size_t)qt * (rows + kScorePad) * 4 + 8 + qt * 4;
}

// K5's query tile: the largest (64, 32, 16, 8) whose keyword weights and
// scores fit; 0 if none
int pick_kw_tile(int kk, int rows) {
  for (int qt = 64; qt >= 8; qt /= 2)
    if (kw_smem_bytes(qt, kk, rows) <= (size_t)kMaxSmem) return qt;
  return 0;
}

template <int QT>
int launch_kw_tile(KwOnlyArgs a, const void* kw8, cudaStream_t stream) {
  CUtensorMap kmap;
  if (!uint8_map(&kmap, kw8, a.b, (long)kChunk * a.kk, QT)) return kErrTensorMap;
  const size_t smem = kw_smem_bytes(QT, a.kk, a.rows_per_group);
  if (smem > (size_t)kMaxSmem) return -1;
  const int q_tiles = (a.b + QT - 1) / QT;
  const long row_groups = a.n / a.rows_per_group;
  a.groups = pick_groups(row_groups, q_tiles);
  if (row_groups / a.groups > 65535) return -1;
  auto kernel = kw_scan_kernel<QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_tiles, (unsigned)(row_groups / a.groups));
  kernel<<<grid, kKwWarpgroups * kWg, smem, stream>>>(kmap, a);
  return (int)cudaGetLastError();
}

// the shapes K1, K4 and T5 take; sets the fields they share
bool common_args(CoarseArgs* a, const void* add_row, const void* scale_row, const void* q_scale,
                 const void* q_bias, void* out_vals, void* out_idxs, int n, int d, int b, int sub,
                 int t1, int packed) {
  if (n <= 0 || n % kTileRows != 0 || d <= 0 || d % 16 != 0 || b <= 0 || sub <= 0 || t1 <= 0 ||
      t1 > sub || n % sub != 0 || (sub % kTileRows != 0 && kTileRows % sub != 0))
    return false;
  a->add_row = static_cast<const float*>(add_row);
  a->scale_row = static_cast<const float*>(scale_row);
  a->q_scale = static_cast<const float*>(q_scale);
  a->q_bias = static_cast<const float*>(q_bias);
  a->out_vals = static_cast<float*>(out_vals);
  a->out_idxs = static_cast<int32_t*>(out_idxs);
  a->n = n; a->b = b; a->sub = sub; a->t1 = t1; a->packed = packed;
  a->kq = (d + kChunk - 1) / kChunk;
  a->rows_per_group = sub > kTileRows ? sub : kTileRows;
  a->groups = 1;
  a->stages = kMinStages;
  return n % a->rows_per_group == 0;
}

// ---- T2 ----

// T2's query tile: the largest (32, 16, 8) whose operand, two score slots and
// a ring of kMinStages stages fit; 0 if none
int pick_pipe_tile(int kq, int rows) {
  for (int qt = 32; qt >= 8; qt /= 2)
    if (pipe_smem_bytes(qt, kq, kMinStages, rows) <= (size_t)kMaxSmem) return qt;
  return 0;
}

template <int QT>
int launch_pipe(PipeArgs a, const Operands& o, int groups, cudaStream_t stream) {
  CUtensorMap qmap, rmap;
  if (!uint8_map(&qmap, o.q8, a.b, o.d, QT)) return kErrTensorMap;
  if (!uint8_map(&rmap, o.emb8, a.n, o.d, kTileRows)) return kErrTensorMap;
  a.stages = kMinStages;
  while (a.stages < kMaxStages &&
         pipe_smem_bytes(QT, a.kq, a.stages + 1, a.rows_per_group) <= (size_t)kMaxSmem)
    ++a.stages;
  const size_t smem = pipe_smem_bytes(QT, a.kq, a.stages, a.rows_per_group);
  const int q_tiles = (a.b + QT - 1) / QT;
  a.row_groups = a.n / a.rows_per_group;
  a.groups = groups <= 0 ? pick_groups(a.row_groups, q_tiles)
                         : groups < a.row_groups ? groups : a.row_groups;
  const int blocks = (a.row_groups + a.groups - 1) / a.groups;
  if (blocks > 65535) return -1;
  auto kernel = int8_pipe_kernel<QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_tiles, (unsigned)blocks);
  kernel<<<grid, kPipeThreads, smem, stream>>>(qmap, rmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// K1's first design (packed = 1) and K7a's (packed = 0), for the shapes
// csrc/int8_coarse.cu does not take: emb8 i8 [n, d], q8 i8 [b, d], add_row,
// scale_row f32 [n], q_scale (0.7 folded in), q_bias f32 [b] -> vals f32, idxs
// i32 [b, n / sub, t1]. n % 128 == 0, d % 16 == 0, sub % 128 == 0 or
// 128 % sub == 0.
extern "C" int omni_int8_coarse_topt(const void* emb8, const void* q8, const void* add_row,
                                     const void* scale_row, const void* q_scale,
                                     const void* q_bias, void* out_vals, void* out_idxs, int n,
                                     int d, int b, int sub, int t1, int packed, void* stream) {
  CoarseArgs a;
  if (!common_args(&a, add_row, scale_row, q_scale, q_bias, out_vals, out_idxs, n, d, b, sub, t1,
                   packed))
    return -1;
  return launch(a, a.kq, Operands{emb8, q8, nullptr, d}, static_cast<cudaStream_t>(stream));
}

// K4: K1's operands, the bloom u8 [n, w], kw_b f32 [b] and the keyword weights
// kw8 i8 [b, 8 wp] in int8_kw_columns order (wp = w rounded up to 16).
extern "C" int omni_int8_fused_topt(const void* emb8, const void* bloom, const void* q8,
                                    const void* kw8, const void* kw_b, const void* add_row,
                                    const void* scale_row, const void* q_scale,
                                    const void* q_bias, void* out_vals, void* out_idxs, int n,
                                    int d, int w, int b, int sub, int t1, int packed,
                                    void* stream) {
  FusedArgs a;
  if (w <= 0 || !common_args(&a, add_row, scale_row, q_scale, q_bias, out_vals, out_idxs, n, d,
                             b, sub, t1, packed))
    return -1;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.kw_b = static_cast<const float*>(kw_b);
  a.w = w;
  a.wp = (w + 15) / 16 * 16;
  a.kk = a.wp / 16;
  return launch(a, a.kq + a.kk, Operands{emb8, q8, kw8, d}, static_cast<cudaStream_t>(stream));
}

// T5: emb8 i8 [n, d], bloom u8 [n, w] (transposed = 0) or [w, n] (transposed
// = 1), q8 i8 [b, d], kw8 i8 [b, 8 w] in int8_kw_columns order, add f32 [n]
// -> out f32 [b, n / 512], the maximum score of each 512-row slice.
// n % 512 == 0, d % 16 == 0, w % 16 == 0.
extern "C" int omni_int8_probe(const void* emb8, const void* bloom, const void* q8,
                               const void* kw8, const void* add_row, void* out, int n, int d,
                               int w, int b, int transposed, void* stream) {
  ProbeArgs a;
  if (w <= 0 || w % 16 != 0 || !common_args(&a, add_row, nullptr, nullptr, nullptr, out,
                                            nullptr, n, d, b, kProbeSlice, 1, 0))
    return -1;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.kw_b = nullptr;
  a.w = a.wp = w;
  a.kk = w / 16;
  a.transposed = transposed;
  return launch(a, a.kq + a.kk, Operands{emb8, q8, kw8, d}, static_cast<cudaStream_t>(stream));
}

// T4: emb8 i8 [n, d], q8 i8 [b, d], scale f32 [n], qs f32 [b]; emit pair
// writes vals f32 and idxs i32 [n / c, b, (c / sub) * t1], P3 keys i32 in that
// layout (out_keys), PF keys i32 [b, (n / sub) * t1]. sub a power of two, c a
// multiple of sub, n % c == 0, n % 128 == 0, d % 16 == 0.
extern "C" int omni_int8_keys_emit(const void* emb8, const void* q8, const void* scale,
                                   const void* qs, void* out_vals, void* out_keys, int n, int d,
                                   int b, int c, int sub, int t1, int emit, void* stream) {
  CoarseArgs shape;
  if (sub < 1 || (sub & (sub - 1)) != 0 || c % sub != 0 || c <= 0 || n % c != 0 ||
      emit < kEmitPair || emit > kEmitPF ||
      !common_args(&shape, nullptr, scale, qs, nullptr, out_vals, out_keys, n, d, b, sub, t1, 1))
    return -1;
  KeysArgs a;
  a.scale_row = shape.scale_row;
  a.q_scale = shape.q_scale;
  a.out_vals = shape.out_vals;
  a.out_idxs = shape.out_idxs;
  a.n = n; a.b = b; a.sub = sub; a.t1 = t1;
  a.kq = shape.kq;
  a.rows_per_group = shape.rows_per_group;
  a.groups = 1;
  a.stages = kMinStages;
  a.emit = emit;
  a.n_sub = c / sub;
  return launch(a, a.kq, Operands{emb8, q8, nullptr, d}, static_cast<cudaStream_t>(stream));
}

// T2: K1's operands and contract (vals f32, idxs i32 [b, n / sub, t1]), each
// block walking `groups` groups of max(sub, 128) rows (0: K1's choice; the
// last block walks what is left). n % 128 == 0, d % 16 == 0, sub % 128 == 0
// or 128 % sub == 0.
extern "C" int omni_int8_pipe_topt(const void* emb8, const void* q8, const void* add_row,
                                   const void* scale_row, const void* q_scale,
                                   const void* q_bias, void* out_vals, void* out_idxs, int n,
                                   int d, int b, int sub, int t1, int packed, int groups,
                                   void* stream) {
  PipeArgs a;
  if (groups < 0 || !common_args(&a, add_row, scale_row, q_scale, q_bias, out_vals, out_idxs, n,
                                 d, b, sub, t1, packed))
    return -1;
  const Operands o{emb8, q8, nullptr, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_pipe_tile(a.kq, a.rows_per_group)) {
    case 32: return launch_pipe<32>(a, o, groups, st);
    case 16: return launch_pipe<16>(a, o, groups, st);
    case 8: return launch_pipe<8>(a, o, groups, st);
    default: return -1;  // no tile configuration fits this shape
  }
}

// T2's query tile at extraction slices of `sub` rows and width d (0: none fits)
extern "C" int omni_int8_pipe_tile(int sub, int d) {
  return pick_pipe_tile((d + kChunk - 1) / kChunk, sub > kTileRows ? sub : kTileRows);
}

// K5: bloom u8 [n, w], kw8 i8 [b, 8 wp] in int8_kw_columns order (wp = w
// rounded up to 16), kw_b f32 [b], add_row f32 [n] -> vals f32, idxs i32
// [b, n / sub, t1]. n % 128 == 0, sub % 128 == 0 or 128 % sub == 0.
extern "C" int omni_int8_kw_topt(const void* bloom, const void* kw8, const void* kw_b,
                                 const void* add_row, void* out_vals, void* out_idxs, int n,
                                 int w, int b, int sub, int t1, int packed, void* stream) {
  if (n <= 0 || n % kTileRows != 0 || w <= 0 || b <= 0 || sub <= 0 || t1 <= 0 || t1 > sub ||
      n % sub != 0 || (sub % kTileRows != 0 && kTileRows % sub != 0))
    return -1;
  KwOnlyArgs a;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.kw_b = static_cast<const float*>(kw_b);
  a.add_row = static_cast<const float*>(add_row);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_idxs);
  a.n = n; a.b = b; a.sub = sub; a.t1 = t1; a.packed = packed;
  a.w = w;
  a.wp = (w + 15) / 16 * 16;
  a.kk = a.wp / 16;
  a.rows_per_group = sub > kTileRows ? sub : kTileRows;
  a.groups = 1;
  if (n % a.rows_per_group != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_kw_tile(a.kk, a.rows_per_group)) {
    case 64: return launch_kw_tile<64>(a, kw8, st);
    case 32: return launch_kw_tile<32>(a, kw8, st);
    case 16: return launch_kw_tile<16>(a, kw8, st);
    case 8: return launch_kw_tile<8>(a, kw8, st);
    default: return -1;  // no tile configuration fits this shape
  }
}

// K5's default query tile at slices of `sub` over W bloom bytes (0: none fits)
extern "C" int omni_int8_kw_query_tile(int sub, int w) {
  return pick_kw_tile((w + 15) / 16, sub > kTileRows ? sub : kTileRows);
}

// the query tile K1's first design (w = 0) or K4 takes at extraction slices
// of `sub` rows, width d and W bloom bytes; 0 if none fits
extern "C" int omni_int8_scan_query_tile(int sub, int d, int w) {
  const int kchunks = (d + kChunk - 1) / kChunk + (w > 0 ? (w + 15) / 16 : 0);
  return pick_tile(kchunks, sub > kTileRows ? sub : kTileRows);
}

extern "C" const char* omni_cuda_error_string(int code) {
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
