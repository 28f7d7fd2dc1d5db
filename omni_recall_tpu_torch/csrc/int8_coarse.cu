// K1, the coarse int8 scan, and its pair mode K7a on Hopper (sm_90a): the
// int8 cosine on the tensor cores (wgmma, s8 in, s32 accumulators) with the
// per-slice top-t1 extraction folded into the epilogue, in registers.
//
// Replaces omni_recall_tpu/ops/pallas_scorer.py block_topt_int8_coarse: the
// pallas_call at :628 (body _make_topt_kernel_int8_coarse_keys_t :347), its
// pair emit K7a (:679, body _make_topt_kernel_int8_coarse :269) and its
// B-major keys K7b (:655), which all decode to the same values:
//   score = fma(cosd * q_scale, scale_row, add_row) + q_bias + 4e-3
// (q_scale arrives with the 0.7 cosine weight folded in; cosd = sum_k
// q8[b, k] emb8[r, k] in int32, exact in any order), then per slice of `sub`
// rows the top-(t1-1) entries and the bound of _extract_topt
// (pallas_scorer.py:105) in both of its modes, written as the decoded
// [B, slices, t1] contract (vals f32, idxs i32, bound entries at index -2).
// The f32 epilogue is the JAX graph's, operation by operation (the library
// builds with -fmad=false): the output is bit for bit the plain version's
// (ops/scorer.py block_topt_int8_coarse_plain) and that of K1's first design
// (csrc/int8_scan.cu int8_scan_kernel<..., CoarseArgs>), which still takes
// the shapes this kernel does not: slices under 128 rows, t1 > 9, d > 1280
// (where the resident queries leave no room for three stages).
//
// What bounds it on the H100: at the serving shape (N = 2^20, d = 768,
// B = 448, sub 1024, t 2) 2*N*d*B = 7.2e11 int8 operations, 0.365 ms at the
// 1979 TOP/s tensor-core peak, over 805 MB of rows (0.24 ms at 3.35 TB/s).
// A block reads each row of its range once for all of its 128 queries, so
// the rows cross from L2 to the SMs ceil(B / 128) times: 4 x 0.805 = 3.2 GB
// a launch (K1's first design, whose [32][sub] f32 score buffer in shared
// memory held its query tile to 32, moved 14 x, 11.3 GB). Streaming that
// alone takes ~0.39 ms (~8 TB/s from L2). The epilogue is ~12 instructions
// a score (the f32 terms, the packed key, a pairwise insertion at t1 = 3),
// 4.7e8 scores. Measured per tile and warpgroup (clock64, B 448): the dot
// ~2,500 cycles (1,536 at the peak) and the epilogue ~2,700-3,100 (~1,700
// with no wgmma running on the SM): the two slow each other down, and their
// sum, not the tensor cores or L2, sets the pace: 0.78 ms at B 448.
//
// Design:
// - Queries are wgmma operand A (m64n128k32.s32.s8.s8), 64 a consumer
//   warpgroup, two consumer warpgroups: 128 queries a block, resident in
//   shared memory, loaded by TMA once a block (zero fill past d and past the
//   batch). Rows are operand B: a tile is 128 rows, one 128-byte K chunk a
//   stage of a TMA ring (as many stages as fit, up to eight), each stage read
//   by both warpgroups. Both operands K-major, as integer wgmma requires.
// - The accumulators stay in registers: a thread holds queries m and m + 8
//   of its warpgroup's 64 (m = 16 (warp % 4) + lane / 4) and rows
//   8 j + 2 (lane % 4) + {0, 1} (j < 16) of a tile; the four lanes of a quad
//   share two queries and split the tile's rows among them.
// - Extraction in registers: each thread folds its scores, in row order,
//   into a running top-T per query (T >= t1, a template: 2, 3, 5 or 9).
//   Packed mode: keys (the score's ordered bits, the low log2(sub) bits
//   lmask - row; unique in a slice, so the t1 largest are what the
//   max-and-mask rounds give), two at a time by a max/min network. Two-reduce
//   mode: (value, row) pairs in (value desc, row asc) order. At a slice's
//   last tile the quad merges its four lists in two shuffle rounds (xor 1,
//   xor 2) and writes the decoded entries; the two-reduce mode applies the
//   rounds' masking rule to the merged list (pair_entry). No score buffer,
//   no block-wide barrier between the dot and the extraction.
// - Ping-pong: the two warpgroups take turns at the tensor cores (named
//   barriers pass the turn once a warpgroup has issued its tile's dot), so
//   each runs its epilogue while the other's dot runs; one accumulator set a
//   warpgroup. Within a dot one wgmma group stays in flight (wait_group 1)
//   and a stage goes back to the producer as soon as both warpgroups'
//   groups on it retired. Running the epilogue between the same warpgroup's
//   own K chunks instead (two accumulator sets) measured 1.0 ms, slower
//   than a dot and an epilogue in turn (0.83 ms).
// - scale_row and add_row of a tile come by bulk copy into a ring of four
//   slots beside the stages, released after both warpgroups' epilogues.
// - A block walks `tiles` tiles of 128 rows (whole slices), at least eight
//   waves of blocks where the rows allow: shorter blocks even out the
//   ragged last query tile. grid.x is the query tile, so the query tiles of
//   one row range run together and read its rows from device memory once,
//   from L2 after that. The last query tile is ragged in steps of 64: a
//   warpgroup with no query of the batch does nothing, the barriers count
//   only the warpgroups with queries, and one warpgroup alone runs its dot
//   and epilogue in turn.
// - Registers: __launch_bounds__(384, 1); the producer warpgroup gives up
//   registers (setmaxnreg 40), the consumers take them (232).

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "topt_extract.cuh"

namespace {

using namespace omni;

constexpr int kWg = 128;                            // threads of a warpgroup
constexpr int kThreads = 3 * kWg;                   // producer + two consumer warpgroups
constexpr int kMaxSmem = 232448;
constexpr int kQueryTile = 128;                     // queries of a block
constexpr int kWgQueries = 64;                      // queries of a consumer warpgroup (M)
constexpr int kTileRows = 128;                      // rows of a tile (N)
constexpr int kChunk = 128;                         // K bytes of a stage
constexpr int kStageBytes = kTileRows * kChunk;
constexpr int kQueryChunkBytes = kQueryTile * kChunk;
constexpr int kNacc = kTileRows / 2;                // accumulators a thread, per tile
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kTermSlots = 4;                       // tiles of row terms in flight
constexpr int kTermBytes = 2 * kTileRows * 4;       // a tile's scale_row, add_row
constexpr int kWaveBlocks = 132 * 8;                // at least this many blocks, where rows allow
constexpr int kMaxGroups = 64;                      // slices' groups a block walks at most
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxT1 = 9;                           // the largest t1 the lists take
constexpr float kEpsInt8 = 4e-3f;                   // PALLAS_CERT_EPS_INT8

// K1's arguments
struct CoarseArgs {
  const float* add_row;   // [n]
  const float* scale_row; // [n]
  const float* q_scale;   // [b], 0.7 folded in
  const float* q_bias;    // [b]
  float* out_vals;        // [b, n / sub, t1]
  int32_t* out_idxs;      // [b, n / sub, t1]
  int n, b, sub, t1;
  int kq;                 // 128-byte K chunks of the rows and queries
  int tiles;              // tiles of 128 rows a block walks (whole slices)
  int stages;             // ring stages
};

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128], s8 x s8 -> s32, both from
// shared memory; acc = 0 overwrites D
__device__ __forceinline__ void wgmma_n128(int (&d)[kNacc], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are read no earlier than here (after the wait that
// retired the wgmmas writing them)
__device__ __forceinline__ void pin(int (&d)[kNacc]) {
#pragma unroll
  for (int i = 0; i < kNacc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// `bytes` (a multiple of 16) from global memory into shared memory,
// completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A running top-T of one query's slice. Packed mode: the T largest keys,
// descending. Two-reduce mode: the T first (value, row) pairs in (value
// desc, row asc) order. Slots past the entries seen hold INT_MIN / (-inf,
// INT_MAX), which every real entry precedes.
template <int T, bool PACKED>
struct TopT;

template <int T>
struct TopT<T, true> {
  int k[T];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < T; ++i) k[i] = INT_MIN;
  }
  // x into the descending list: each slot keeps the larger of itself and
  // the smaller of x and the slot above (all from the old list)
  __device__ __forceinline__ void insert(int x) {
#pragma unroll
    for (int i = T - 1; i > 0; --i) k[i] = max(k[i], min(k[i - 1], x));
    k[0] = max(k[0], x);
  }
  // x and y into the list: the sorted pair (hi, lo) merged in, slot i the
  // largest of k[i], min(k[i-1], hi) and min(k[i-2], lo) (four operations a
  // key at T = 3, with three-input maxima, against insert's five)
  __device__ __forceinline__ void insert2(int x, int y) {
    const int hi = max(x, y), lo = min(x, y);
#pragma unroll
    for (int i = T - 1; i > 1; --i) k[i] = max(k[i], max(min(k[i - 1], hi), min(k[i - 2], lo)));
    if (T > 1) k[1] = max(k[1], max(min(k[0], hi), lo));
    k[0] = max(k[0], hi);
  }
  // the union with the list of lane ^ `lanes`
  __device__ __forceinline__ void merge(int lanes) {
    int o[T];
#pragma unroll
    for (int i = 0; i < T; ++i) o[i] = __shfl_xor_sync(0xffffffffu, k[i], lanes);
#pragma unroll
    for (int i = 0; i < T; ++i) insert(o[i]);
  }
};

template <int T>
struct TopT<T, false> {
  float v[T];
  int r[T];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < T; ++i) v[i] = __int_as_float(0xff800000), r[i] = INT_MAX;
  }
  // (x, row) into the list, given that every entry in it has a lower row:
  // it goes after the entries of its value
  __device__ __forceinline__ void push(float x, int row) {
#pragma unroll
    for (int i = T - 1; i > 0; --i) {
      const bool ci = x > v[i], cp = x > v[i - 1];
      v[i] = ci ? (cp ? v[i - 1] : x) : v[i];
      r[i] = ci ? (cp ? r[i - 1] : row) : r[i];
    }
    if (x > v[0]) v[0] = x, r[0] = row;
  }
  // (x, row) into the list in (value desc, row asc) order
  static __device__ __forceinline__ bool before(float x, int row, float v, int r) {
    return x > v || (x == v && row < r);
  }
  __device__ __forceinline__ void insert(float x, int row) {
#pragma unroll
    for (int i = T - 1; i > 0; --i) {
      const bool ci = before(x, row, v[i], r[i]), cp = before(x, row, v[i - 1], r[i - 1]);
      v[i] = ci ? (cp ? v[i - 1] : x) : v[i];
      r[i] = ci ? (cp ? r[i - 1] : row) : r[i];
    }
    if (before(x, row, v[0], r[0])) v[0] = x, r[0] = row;
  }
  __device__ __forceinline__ void merge(int lanes) {
    float ov[T];
    int orow[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      ov[i] = __shfl_xor_sync(0xffffffffu, v[i], lanes);
      orow[i] = __shfl_xor_sync(0xffffffffu, r[i], lanes);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) insert(ov[i], orow[i]);
  }
};

// The two-reduce rounds of a slice from its sorted list E (E[0 .. t1-1]
// real entries): round r < t1 - 1 takes the largest value and the lowest
// row holding it, then sets that entry to M = -1e30 (kExtractNegInf); the
// bound is the largest left. While the value taken is above M the rounds
// take E[0], E[1], ... in turn. From the first round r* whose E[r*] is at
// most M on, every entry left is at most M and the masked ones are M, so:
// at r* = 0 round 0 takes E[0] and later rounds (M, E[0]'s row); at r* >= 1
// every round from r* takes M at the lowest row among the masked E[0 ..
// r*-1] and E[r*] if it is M. The bound is max(E[t1-1], M) after a masked
// round (E[0] at t1 = 1). Entry r of the t1 written.
template <int T>
__device__ __forceinline__ void pair_entry(const TopT<T, false>& e, int t1, int r, float* val,
                                           int* row) {
  int rstar = t1 - 1;
#pragma unroll
  for (int i = T - 2; i >= 0; --i)
    if (i < t1 - 1 && e.v[i] <= kExtractNegInf) rstar = i;
  int hit = INT_MAX;
#pragma unroll
  for (int i = 0; i < T; ++i)
    if (i < rstar || (i == rstar && e.v[i] == kExtractNegInf)) hit = min(hit, e.r[i]);
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i != r) continue;
    if (i == t1 - 1) {
      *val = i == 0 ? e.v[0] : fmaxf(e.v[i], kExtractNegInf);
      *row = -2;
    } else if (i < rstar) {
      *val = e.v[i];
      *row = e.r[i];
    } else if (rstar == 0) {
      *val = i == 0 ? e.v[0] : kExtractNegInf;
      *row = e.r[0];
    } else {
      *val = kExtractNegInf;
      *row = hit;
    }
  }
}

constexpr size_t smem_bytes(int kq, int stages) {
  return 1024 + (size_t)kq * kQueryChunkBytes + (size_t)stages * kStageBytes +
         (size_t)kTermSlots * kTermBytes + (size_t)(2 * stages + 2 * kTermSlots + 1) * 8;
}

// A consumer warpgroup's side of the kernel: its 64 queries' terms and
// lists, its place in the stage and terms rings, and the steps of a tile
template <int T, bool PACKED>
struct Consumer {
  const CoarseArgs& a;
  const float* terms;      // the terms ring: [kTermSlots][scale_row 128, add_row 128]
  uint32_t full0, empty0, tfull0, tempty0;
  uint32_t bq_addr, ring_addr;
  int row_base, quad, qa;  // the thread's queries: qa, qa + 8
  int lmask;               // packed mode: sub - 1 (sub a power of two)
  float qsc[2], qb[2];
  TopT<T, PACKED> list[2];
  int stage = 0, prev_stage = 0, slot = 0;
  uint32_t phase = 0, tphase = 0;

  int acc[kNacc];  // the warpgroup's accumulators of the tile

  // after tile te's epilogue: free its terms' slot and, at the end of a
  // slice, merge the quad's four lists and write the slice's entries
  __device__ __forceinline__ void finish(int te) {
    mbar_arrive(tempty0 + 8 * slot);
    if (++slot == kTermSlots) { slot = 0; tphase ^= 1; }
    const int end = row_base + (te + 1) * kTileRows;
    if (end % a.sub != 0) return;
    const int base = end - a.sub;
    const size_t n_slices = a.n / a.sub;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      list[h].merge(1);
      list[h].merge(2);
      const int q = qa + 8 * h;
      if (q < a.b) {
        const size_t o = ((size_t)q * n_slices + base / a.sub) * a.t1;
#pragma unroll
        for (int r = 0; r < T; ++r) {
          if (r >= a.t1 || (r & 3) != quad) continue;
          if constexpr (PACKED) {
            const int k = list[h].k[r];
            a.out_vals[o + r] = decode_up(k, lmask);
            a.out_idxs[o + r] = r == a.t1 - 1 ? -2 : (lmask - (k & lmask)) + base;
          } else {
            float v;
            int row;
            pair_entry(list[h], a.t1, r, &v, &row);
            a.out_vals[o + r] = v;
            a.out_idxs[o + r] = row;
          }
        }
      }
      list[h].reset();
    }
  }

  // tile t's dot: the K chunks' wgmmas, one group in flight; a stage goes
  // back to the producer as soon as its group retires
  __device__ __forceinline__ void dot() {
    for (int kc = 0; kc < a.kq; ++kc) {
      mbar_wait(full0 + 8 * stage, phase);
      wg_fence();
      const uint32_t qa_addr = bq_addr + kc * kQueryChunkBytes;
      const uint32_t rb_addr = ring_addr + stage * kStageBytes;
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks)
        wgmma_n128(acc, sw128_desc(qa_addr + ks * 32), sw128_desc(rb_addr + ks * 32),
                   (kc | ks) != 0);
      wg_commit();
      if (kc > 0) {
        wg_wait<1>();
        mbar_arrive(empty0 + 8 * prev_stage);
      }
      prev_stage = stage;
      if (++stage == a.stages) { stage = 0; phase ^= 1; }
    }
  }

  // tile te's epilogue, once its dot is done: each score in the JAX
  // operation order, folded into its query's list (packed keys two at a
  // time, rows 8 j + 2 quad and the next)
  __device__ __forceinline__ void epilogue(int te) {
    wg_wait<0>();
    mbar_arrive(empty0 + 8 * prev_stage);
    pin(acc);
    mbar_wait(tfull0 + 8 * slot, tphase);
    const float* sr = terms + slot * 2 * kTileRows + 2 * quad;
    const float* ar = sr + kTileRows;
    const int row0 = row_base + te * kTileRows;
    const int e0 = (row0 & lmask) + 2 * quad;  // packed: the row in its slice
    const int r0 = row0 + 2 * quad;             // two-reduce: the row
#pragma unroll
    for (int j = 0; j < kTileRows / 8; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(sr + 8 * j);
      const float2 a2 = *reinterpret_cast<const float2*>(ar + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int key[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s = __fmaf_rn(__fmul_rn((float)acc[4 * j + 2 * h + c], qsc[h]),
                              c ? s2.y : s2.x, c ? a2.y : a2.x);
          s = __fadd_rn(__fadd_rn(s, qb[h]), kEpsInt8);
          if constexpr (PACKED) {
            // the key: low bits lmask - e, which is lmask ^ e (e <= lmask)
            const int si = __float_as_int(s);
            const int kf = si ^ ((si >> 31) & 0x7FFFFFFF);
            key[c] = (kf | lmask) ^ (e0 + 8 * j + c);
          } else {
            list[h].push(s, r0 + 8 * j + c);
          }
        }
        if constexpr (PACKED) list[h].insert2(key[0], key[1]);
      }
    }
    finish(te);
  }
};

// the warpgroups' turns at the tensor cores: named barrier 1 + wg is
// warpgroup wg's (0 is __syncthreads'), passed by the other warpgroup
__device__ __forceinline__ void bar_sync_n(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive_n(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int T, bool PACKED, class A>
__global__ void __launch_bounds__(kThreads, 1)
    int8_coarse_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap rmap, const __grid_constant__ A a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bq = sm;                                      // [kq][128 queries][128 B]
  unsigned char* ring = bq + (size_t)a.kq * kQueryChunkBytes;  // [stages][128 rows][128 B]
  float* terms = reinterpret_cast<float*>(ring + (size_t)a.stages * kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(terms + kTermSlots * 2 * kTileRows);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + a.stages);
  const uint32_t tfull0 = smem_u32(bars + 2 * a.stages);
  const uint32_t tempty0 = smem_u32(bars + 2 * a.stages + kTermSlots);
  const uint32_t q_full = smem_u32(bars + 2 * a.stages + 2 * kTermSlots);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueryTile;
  const int busy_wgs = a.b - q0 > kWgQueries ? 2 : 1;  // consumer warpgroups with queries
  const int row_base = blockIdx.y * a.tiles * kTileRows;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, busy_wgs * kWg);
    }
    for (int s = 0; s < kTermSlots; ++s) {
      mbar_init(tfull0 + 8 * s, 1);
      mbar_init(tempty0 + 8 * s, busy_wgs * kWg);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(q_full, (uint32_t)(kQueryChunkBytes * a.kq));
      for (int c = 0; c < a.kq; ++c)
        tma_load_2d(smem_u32(bq + (size_t)c * kQueryChunkBytes), &qmap, c * kChunk, q0, q_full);
      int stage = 0, slot = 0;
      uint32_t phase = 0, tphase = 0;
      for (int t = 0; t < a.tiles; ++t) {
        const int row0 = row_base + t * kTileRows;
        // the tile's row terms: scale_row, then add_row
        mbar_wait(tempty0 + 8 * slot, tphase ^ 1);
        mbar_expect_tx(tfull0 + 8 * slot, kTermBytes);
        const uint32_t dst = smem_u32(terms + slot * 2 * kTileRows);
        bulk_load(dst, a.scale_row + row0, kTileRows * 4, tfull0 + 8 * slot);
        bulk_load(dst + kTileRows * 4, a.add_row + row0, kTileRows * 4, tfull0 + 8 * slot);
        if (++slot == kTermSlots) { slot = 0; tphase ^= 1; }
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
    // ---- consumer warpgroups: 64 queries each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = (tid - kWg) / kWg;
    if (wg >= busy_wgs) return;  // the ragged tile's second half: no query of the batch
    const int lane = tid & 31;
    Consumer<T, PACKED> c{a, terms, full0, empty0, tfull0, tempty0,
                          smem_u32(bq) + wg * kWgQueries * kChunk, smem_u32(ring), row_base,
                          lane & 3, q0 + wg * kWgQueries + ((tid >> 5) & 3) * 16 + (lane >> 2),
                          a.sub - 1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = c.qa + 8 * h;
      c.qsc[h] = q < a.b ? a.q_scale[q] : 0.0f;
      c.qb[h] = q < a.b ? a.q_bias[q] : 0.0f;
      c.list[h].reset();
    }
#pragma unroll
    for (int i = 0; i < kNacc; ++i) c.acc[i] = 0;
    mbar_wait(q_full, 0);
    // ping-pong: the warpgroups take turns at the tensor cores, each running
    // its tile's epilogue while the other's dot runs (a warpgroup alone, at
    // the batch's ragged end, runs dot and epilogue in turn)
    const bool pp = busy_wgs == 2;
    for (int t = 0; t < a.tiles; ++t) {
      if (pp && (wg == 1 || t > 0)) bar_sync_n(1 + wg, 2 * kWg);
      c.dot();
      if (pp && (wg == 0 || t + 1 < a.tiles)) bar_arrive_n(2 - wg, 2 * kWg);
      c.epilogue(t);
    }
  }
}

// ---- host side ----

// ring stages beside the resident queries: as many as fit, up to
// kMaxStages; 0 if fewer than kMinStages fit
int pick_stages(int kq) {
  int s = 0;
  for (int k = kMinStages; k <= kMaxStages; ++k)
    if (smem_bytes(kq, k) <= (size_t)kMaxSmem) s = k;
  return s;
}

// the list length a launch takes: the smallest template at least t1
int list_slots(int t1, int packed) {
  if (t1 < 1 || t1 > kMaxT1) return 0;
  if (packed) return t1 < 3 ? 0 : t1 <= 3 ? 3 : t1 <= 5 ? 5 : 9;
  return t1 <= 2 ? 2 : 9;
}

bool takes(int d, int sub, int t1, int packed) {
  const int kq = (d + kChunk - 1) / kChunk;
  return d > 0 && d % 16 == 0 && sub > 0 && sub % kTileRows == 0 && t1 <= sub &&
         (!packed || (sub & (sub - 1)) == 0) && pick_stages(kq) > 0 &&
         list_slots(t1, packed) > 0;
}

// slices' groups a block walks: the largest power of two (at most
// kMaxGroups) that divides the slices and leaves at least kWaveBlocks blocks
int pick_groups(long slices, int q_tiles) {
  int g = 1;
  while (g * 2 <= kMaxGroups && slices % (g * 2) == 0 &&
         (slices / (g * 2)) * q_tiles >= kWaveBlocks)
    g *= 2;
  return g;
}

bool uint8_map(CUtensorMap* map, const void* ptr, long rows, long cols, int box_rows) {
  return sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, cols, box_rows);
}

template <int T, bool PACKED>
int launch(CoarseArgs a, const void* emb8, const void* q8, int d, cudaStream_t stream) {
  CUtensorMap qmap, rmap;
  if (!uint8_map(&qmap, q8, a.b, d, kQueryTile)) return kErrTensorMap;
  if (!uint8_map(&rmap, emb8, a.n, d, kTileRows)) return kErrTensorMap;
  const size_t smem = smem_bytes(a.kq, a.stages);
  const int q_tiles = (a.b + kQueryTile - 1) / kQueryTile;
  const long slices = a.n / a.sub;
  const int groups = pick_groups(slices, q_tiles);
  if (slices / groups > 65535) return -1;
  a.tiles = groups * (a.sub / kTileRows);
  auto kernel = int8_coarse_kernel<T, PACKED, CoarseArgs>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_tiles, (unsigned)(slices / groups));
  kernel<<<grid, kThreads, smem, stream>>>(qmap, rmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The queries one block of K1 scores at width d, slices of `sub` rows and
// t1 entries a slice (packed: the packed-key mode): 128 where this kernel
// takes the shape, else 0 (csrc/int8_scan.cu's first design takes it).
extern "C" int omni_int8_coarse_query_tile(int d, int sub, int t1, int packed) {
  return takes(d, sub, t1, packed) ? kQueryTile : 0;
}

// K1 (packed = 1) and K7a (packed = 0): emb8 i8 [n, d], q8 i8 [b, d],
// add_row, scale_row f32 [n], q_scale (0.7 folded in), q_bias f32 [b] ->
// vals f32, idxs i32 [b, n / sub, t1]. n % sub == 0, a shape
// omni_int8_coarse_query_tile takes.
extern "C" int omni_int8_coarse(const void* emb8, const void* q8, const void* add_row,
                                const void* scale_row, const void* q_scale, const void* q_bias,
                                void* out_vals, void* out_idxs, int n, int d, int b, int sub,
                                int t1, int packed, void* stream) {
  if (n <= 0 || b <= 0 || !takes(d, sub, t1, packed) || n % sub != 0) return -1;
  CoarseArgs a;
  a.add_row = static_cast<const float*>(add_row);
  a.scale_row = static_cast<const float*>(scale_row);
  a.q_scale = static_cast<const float*>(q_scale);
  a.q_bias = static_cast<const float*>(q_bias);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_idxs);
  a.n = n; a.b = b; a.sub = sub; a.t1 = t1;
  a.kq = (d + kChunk - 1) / kChunk;
  a.tiles = 0;
  a.stages = pick_stages(a.kq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (list_slots(t1, packed) * 2 + (packed ? 1 : 0)) {
    case 3 * 2 + 1: return launch<3, true>(a, emb8, q8, d, st);
    case 5 * 2 + 1: return launch<5, true>(a, emb8, q8, d, st);
    case 9 * 2 + 1: return launch<9, true>(a, emb8, q8, d, st);
    case 2 * 2: return launch<2, false>(a, emb8, q8, d, st);
    case 9 * 2: return launch<9, false>(a, emb8, q8, d, st);
    default: return -1;
  }
}

extern "C" const char* omni_cuda_error_string(int code) {
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
