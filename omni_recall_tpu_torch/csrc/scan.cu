// Hand-written Hopper (sm_90a) kernels for the int8 hybrid scans.
//
// One templated source serves three TPU kernels of omni_recall_tpu/ops/pallas_scorer.py
// and three probes of the repository's tools/:
//
//   MODE 0, K1  coarse int8 scan   _make_topt_kernel_int8_coarse_keys_t (transposed
//               packed emit) and its pair-emit twin _make_topt_kernel_int8_coarse (K7a):
//               score = fma(cosd * q_scale, scale_row, add_row) + q_bias + 4e-3
//               (q_scale arrives pre-multiplied by the 0.7 cosine weight)
//   MODE 1, K4  full fused int8 scan  _make_topt_kernel_int8 / _ub_block_int8:
//               kw    = min(fma(kwd, 1/127, kw_b), 1)
//               score = fma(0.7, (cosd * q_scale) * scale_row, 0.2 * kw)
//                     + add_row + q_bias + 4e-3
//   MODE 2, K5  keyword-only scan  _make_topt_kernel_kw_only:
//               score = fma(0.2, kw, add_row) + 4e-3
//   MODE 3, T5  the profiling probe of tools/profile_bloomT.py (the pallas_call of
//               `variant` at :39, body `kernel` :22): K4's int8 cosine and keyword
//               dots with the tool's epilogue, its constants folded as XLA folds
//               them and the cosine term contracted (found against the
//               interpret-mode tool body):
//               score = fma(cosd, f32(0.7 * 1e-4), kwd * f32(0.2 * f32(1/127))) + add
//               and only the maximum of each 512-row slice (the bound entry of the
//               two-reduce extraction at t1 = 1), values only, [B, N/512]. The bloom
//               arrives as rows [N, W] or transposed [W, N] (bit j is bit j / W of
//               word j % W in both): a row tile's bytes are then W runs of 64
//               bytes, N apart, against one run of 64 * W bytes. Both layouts are
//               staged with 16-byte loads, four neighbouring threads on each run of
//               64 in the transposed one. At N = 2^20, d = 768, W = 128, B = 448
//               it does K4's 1.7e12 operations (0.851 ms at the int8 peak).
//   MODE 4, T2  tools/probe_pipe.py (the pallas_call at :85, body _make_pipe_kernel
//               :34): K1's body and extraction, software-pipelined. Its own kernel,
//               pipe_kernel below: a block owns S consecutive extraction slices of
//               one query tile and two shared-memory score slots of [QT][sub] f32;
//               8 scoring warps score slice s into slot s % 2 (K1's dot_tile and
//               epilogue) while 4 extraction warps extract slice s - 1 from the
//               other slot. The slots change hands at named barriers (bar.arrive by
//               the side that hands a slot over, bar.sync by the side that takes
//               it). Same scores, same rounds: the output is K1's, bit for bit.
//   MODE 5, T4  tools/probe_keys_emit.py (kern_pair :123, kern_p3 :136,
//               kern_pf :142): K1's dp4a tiles with the tool's bare epilogue
//               score = (cosd * qs) * scale (no add_row, bias or eps; the order
//               found against the interpret-mode body), the packed-key rounds at
//               every t1, and one of three emits, each layout written by the kernel:
//               pair (decoded vals + global idxs) and P3 (raw packed keys) block-major
//               [N/c, B, (c/sub) * t1], PF (raw keys) flat [B, (N/sub) * t1].
//
// followed by the per-slice top-(t1-1) + bound extraction of _extract_topt, in both of
// its modes (packed keys when sub is a power of two and t1 >= 3, else value/index
// two-reduce). The output is the decoded [B, slices, t1] contract directly (vals f32,
// idxs i32, bound entries carry index -2), bit for bit what the TPU kernels decode to.
//
// What bounds it on the H100: at the serving shapes (N = 2^20, d = 768, W = 128,
// B = 448) K1 does 2*N*d*B = 7.2e11 int8 operations over 805 MB of rows (0.36 ms at
// the 1979 TOP/s int8 tensor-core peak), K4 1.7e12 over 940 MB, K5 9.6e11 over 134 MB:
// all three are operation-bound on the tensor cores. This first version is the
// simple, exact one: int32 __dp4a dot products on the CUDA cores (exact, like the
// MXU's int32 accumulation), no tensor cores, no TMA, so it runs well below that
// bound; a wgmma version is later work.
//
// Design: Hopper blocks run in parallel and in no order, so one block owns whole
// extraction slices (R = max(sub, ROWS) rows) for a tile of QT queries and nothing
// carries between blocks. The block streams its rows through shared memory ROWS at
// a time (16-byte vector loads, row stride padded to an odd number of 16-byte words
// so the 128-bit shared loads are conflict free), scores them with a 2-rows x 4-query
// register tile per thread, and keeps the f32 scores of all R rows in shared memory.
// Then each warp runs the literal max-and-mask rounds of _extract_topt for its
// queries with warp shuffles (topt_extract.cuh, shared with fp_scan.cu). The keyword dot unpacks each bloom byte into eight
// 0/1 int8 lanes (column j of the JAX bit matrix is bit j / W of word j % W) and
// reorders kw_w8 word-major to match, so it is the same exact int8 dot.
//
// f32 arithmetic follows the JAX graphs operation by operation with __fmul_rn /
// __fadd_rn / __fmaf_rn (and the library builds with -fmad=false, so the compiler
// contracts nothing on its own). The explicit fused multiply-adds sit exactly where
// XLA's compiler contracts the JAX graph (scorer.py _fma32 says how that was
// established): the scores, and everything extracted from them, are bit-identical.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "topt_extract.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr float kEpsInt8 = 4e-3f;       // PALLAS_CERT_EPS_INT8
constexpr float kCosW = 0.7f;           // COSINE_WEIGHT
constexpr float kKwW = 0.2f;            // KEYWORD_WEIGHT
constexpr float kInv127 = (float)(1.0 / 127.0);

enum Mode : int { kCoarse = 0, kFused = 1, kKwOnly = 2, kProbe = 3, kPipe = 4, kKeys = 5 };
enum KeysEmit : int { kEmitPair = 0, kEmitP3 = 1, kEmitPF = 2 };  // T4's emits

// T5's constants, each folded to one f32 as XLA folds the tool's graph
constexpr float kProbeCos = kCosW * 1e-4f;
constexpr float kProbeKw = kKwW * kInv127;

struct Args {
  const int8_t* emb8;
  const uint8_t* bloom;
  const int8_t* q8;
  const int8_t* kw_w8;
  const float* kw_b;
  const float* add_row;
  const float* scale_row;
  const float* q_scale;
  const float* q_bias;
  float* out_vals;
  int32_t* out_idxs;
  int n, d;
  union {       // T4 reads no bloom: the same word holds its layout
    int w;      // bloom words
    int n_sub;  // T4: extraction slices per tool block (c / sub)
  };
  int b, sub, t1, packed;
  int rows_per_block;  // R (T2: its S slices of sub rows)
  int se;              // shared row stride (bytes) of emb rows
  union {
    int sk;    // shared row stride (bytes) of unpacked bloom rows
    int emit;  // T4: KeysEmit
  };
};
// (Args keeps its size and layout: one more field moves the registers of
// every scan_kernel instantiation: omni_recall_tpu_torch/tools/ptxas_report.py)

// a multiple of 16 bytes whose count of 16-byte words is odd (conflict-free
// 128-bit shared loads across consecutive rows)
inline int pad_stride(int k) { return k + ((k / 16) % 2 == 0 ? 16 : 32); }

// four low bits of n -> four 0/1 bytes (bit i -> byte i)
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

// acc[i][j] += rows[lane + 32 i] . qs[warp * QPT + j] over K bytes (K % 16 == 0)
template <int RPT, int QPT>
__device__ __forceinline__ void dot_tile(const int8_t* rows, int rs, const int8_t* qs,
                                         int K, int lane, int warp, int (&acc)[RPT][QPT]) {
  for (int k = 0; k < K; k += 16) {
    int4 ra[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      ra[i] = *reinterpret_cast<const int4*>(rows + (lane + 32 * i) * rs + k);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int4 qv = *reinterpret_cast<const int4*>(qs + (warp * QPT + j) * rs + k);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        int a = acc[i][j];
        a = __dp4a(ra[i].x, qv.x, a);
        a = __dp4a(ra[i].y, qv.y, a);
        a = __dp4a(ra[i].z, qv.z, a);
        a = __dp4a(ra[i].w, qv.w, a);
        acc[i][j] = a;
      }
    }
  }
}

// one row tile's bloom bytes (rows tr0 .. tr0 + ROWS) unpacked into tile rows of
// 8W 0/1 bytes (word-major, byte w * 8 + b holds bit b of word w), by 16-byte
// loads: from rows [N, W] (W % 16 == 0) or transposed [W, N]
template <int ROWS, bool BLOOM_T>
__device__ __forceinline__ void stage_bloom16(const uint8_t* bloom, int n, int w, long tr0,
                                              int8_t* tile, int sk, int tid) {
  constexpr int RV = ROWS / 16;  // 16-byte runs of one word in a transposed tile
  const int nv = BLOOM_T ? w * RV : ROWS * (w / 16);
  for (int i = tid; i < nv; i += kThreads) {
    int r0, wd0, dr, dw;  // first row and word of the 16 bytes, and their steps
    const uint8_t* src;
    if (BLOOM_T) {
      wd0 = i / RV, r0 = (i % RV) * 16, dr = 1, dw = 0;
      src = bloom + (size_t)wd0 * n + tr0 + r0;
    } else {
      r0 = i / (w / 16), wd0 = (i % (w / 16)) * 16, dr = 0, dw = 1;
      src = bloom + (size_t)(tr0 + r0) * w + wd0;
    }
    const int4 v = *reinterpret_cast<const int4*>(src);
    const uint32_t words[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t byte = (words[k / 4] >> (8 * (k % 4))) & 0xFFu;
      *reinterpret_cast<uint2*>(tile + (r0 + k * dr) * sk + (wd0 + k * dw) * 8) =
          make_uint2(expand4(byte & 15u), expand4(byte >> 4));
    }
  }
}

// T4's block-major layout [N/c, B, n_sub * t1]: global slice = blk * n_sub + j
struct BlockMajor {
  int b, n_sub;
  __device__ __forceinline__ size_t operator()(int qg, long slice, long, int t1) const {
    return (((size_t)(slice / n_sub) * b + qg) * n_sub + slice % n_sub) * t1;
  }
};

template <int MODE, int ROWS, int QT, bool BLOOM_T = false>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  constexpr bool kEmb = MODE != kKwOnly;
  constexpr bool kKw = MODE != kCoarse && MODE != kKeys;
  constexpr int RPT = ROWS / 32;
  constexpr int QPT = QT / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.rows_per_block;
  const long row0 = (long)blockIdx.x * R;
  const int q0 = blockIdx.y * QT;
  const int tile_stride = max(kEmb ? a.se : 0, kKw ? a.sk : 0);

  unsigned char* p = smem;
  int8_t* qs = reinterpret_cast<int8_t*>(p);
  if (kEmb) p += QT * a.se;
  int8_t* kws = reinterpret_cast<int8_t*>(p);
  if (kKw) p += QT * a.sk;
  int8_t* tile = reinterpret_cast<int8_t*>(p);
  p += ROWS * tile_stride;
  float* sc = reinterpret_cast<float*>(p);  // [QT][R] scores

  // query operands (zero rows past the batch end)
  if (kEmb) {
    const int dv = a.d / 16;
    for (int i = tid; i < QT * dv; i += kThreads) {
      const int qi = i / dv, v = i % dv;
      int4 val = make_int4(0, 0, 0, 0);
      if (q0 + qi < a.b)
        val = reinterpret_cast<const int4*>(a.q8 + (size_t)(q0 + qi) * a.d)[v];
      reinterpret_cast<int4*>(qs + qi * a.se)[v] = val;
    }
  }
  if (kKw) {
    // word-major reorder: JAX column j = b * W + w  ->  shared w * 8 + b
    const int K = 8 * a.w;
    for (int i = tid; i < QT * K; i += kThreads) {
      const int qi = i / K, j = i % K;
      int8_t v = 0;
      if (q0 + qi < a.b) v = a.kw_w8[(size_t)(q0 + qi) * K + j];
      kws[qi * a.sk + (j % a.w) * 8 + j / a.w] = v;
    }
  }
  float qsc[QPT], qb[QPT], kb[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qg = q0 + warp * QPT + j;
    const bool ok = qg < a.b;
    qsc[j] = (kEmb && MODE != kProbe && ok) ? a.q_scale[qg] : 0.0f;
    qb[j] = (MODE != kKwOnly && MODE != kProbe && MODE != kKeys && ok) ? a.q_bias[qg] : 0.0f;
    kb[j] = (kKw && MODE != kProbe && ok) ? a.kw_b[qg] : 0.0f;
  }

  for (int rt = 0; rt < R; rt += ROWS) {
    const long tr0 = row0 + rt;
    int acc_c[RPT][QPT], acc_k[RPT][QPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc_c[i][j] = acc_k[i][j] = 0;

    if (kEmb) {
      __syncthreads();  // previous tile fully consumed
      const int dv = a.d / 16;
      const int4* src = reinterpret_cast<const int4*>(a.emb8 + tr0 * a.d);
      for (int i = tid; i < ROWS * dv; i += kThreads)
        reinterpret_cast<int4*>(tile + (i / dv) * a.se)[i % dv] = src[i];
      __syncthreads();
      dot_tile<RPT, QPT>(tile, a.se, qs, a.d, lane, warp, acc_c);
    }
    if (kKw) {
      __syncthreads();
      if (MODE == kProbe) {
        stage_bloom16<ROWS, BLOOM_T>(a.bloom, a.n, a.w, tr0, tile, a.sk, tid);
      } else {
        for (int i = tid; i < ROWS * a.w; i += kThreads) {
          const int r = i / a.w, wd = i % a.w;
          const uint32_t byte = a.bloom[(tr0 + r) * a.w + wd];
          *reinterpret_cast<uint2*>(tile + r * a.sk + wd * 8) =
              make_uint2(expand4(byte & 15u), expand4(byte >> 4));
        }
      }
      __syncthreads();
      dot_tile<RPT, QPT>(tile, a.sk, kws, 8 * a.w, lane, warp, acc_k);
    }

    // f32 epilogue in the JAX operation order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = lane + 32 * i;
      const long r = tr0 + rl;
      const float ar = MODE != kKeys ? a.add_row[r] : 0.0f;
      const float sr = (kEmb && MODE != kProbe) ? a.scale_row[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float s;
        if (MODE == kCoarse) {
          s = __fmaf_rn(__fmul_rn((float)acc_c[i][j], qsc[j]), sr, ar);
          s = __fadd_rn(__fadd_rn(s, qb[j]), kEpsInt8);
        } else if (MODE == kProbe) {
          s = __fmaf_rn((float)acc_c[i][j], kProbeCos, __fmul_rn((float)acc_k[i][j], kProbeKw));
          s = __fadd_rn(s, ar);
        } else if (MODE == kKeys) {
          s = __fmul_rn(__fmul_rn((float)acc_c[i][j], qsc[j]), sr);
        } else {
          const float kw = fminf(__fmaf_rn((float)acc_k[i][j], kInv127, kb[j]), 1.0f);
          if (MODE == kFused) {
            const float cos = __fmul_rn(__fmul_rn((float)acc_c[i][j], qsc[j]), sr);
            s = __fmaf_rn(kCosW, cos, __fmul_rn(kKwW, kw));
            s = __fadd_rn(__fadd_rn(__fadd_rn(s, ar), qb[j]), kEpsInt8);
          } else {
            s = __fadd_rn(__fmaf_rn(kKwW, kw, ar), kEpsInt8);
          }
        }
        sc[(warp * QPT + j) * R + rt + rl] = s;
      }
    }
  }
  __syncthreads();

  // extraction: warp `warp` owns queries warp * QPT + j (topt_extract.cuh)
  const long n_slices = a.n / a.sub;
  for (int j = 0; j < QPT; ++j) {
    const int ql = warp * QPT + j, qg = q0 + ql;
    if (qg >= a.b) continue;  // warp-uniform
    if (MODE == kProbe)
      omni::extract_query<false>(sc + ql * R, R, a.sub, 1, 0, row0, n_slices, qg,
                                 a.out_vals, nullptr, lane);
    else if (MODE == kKeys && a.emit == kEmitPF)  // the contract's own layout, flat
      omni::extract_query<false, omni::kRawKeys>(sc + ql * R, R, a.sub, a.t1, 1, row0,
                                                 n_slices, qg, nullptr, a.out_idxs, lane);
    else if (MODE == kKeys && a.emit == kEmitP3)
      omni::extract_query<false, omni::kRawKeys>(sc + ql * R, R, a.sub, a.t1, 1, row0,
                                                 n_slices, qg, nullptr, a.out_idxs, lane,
                                                 BlockMajor{a.b, a.n_sub});
    else if (MODE == kKeys)
      omni::extract_query(sc + ql * R, R, a.sub, a.t1, 1, row0, n_slices, qg, a.out_vals,
                          a.out_idxs, lane, BlockMajor{a.b, a.n_sub});
    else
      omni::extract_query(sc + ql * R, R, a.sub, a.t1, a.packed, row0, n_slices, qg,
                          a.out_vals, a.out_idxs, lane);
  }
}

template <int MODE, int ROWS, int QT, bool BLOOM_T = false>
int try_launch(Args a, cudaStream_t stream, bool* launched) {
  if (a.sub % ROWS != 0 && ROWS % a.sub != 0) return 0;
  a.rows_per_block = a.sub > ROWS ? a.sub : ROWS;
  if (a.n % a.rows_per_block != 0) return 0;
  const bool emb = MODE != kKwOnly, kw = MODE != kCoarse && MODE != kKeys;
  const int se = emb ? a.se : 0, sk = kw ? a.sk : 0;
  const int tile_stride = se > sk ? se : sk;
  const size_t smem = (emb ? (size_t)QT * a.se : 0) + (kw ? (size_t)QT * a.sk : 0) +
                      (size_t)ROWS * tile_stride + (size_t)QT * a.rows_per_block * 4;
  if (smem > (size_t)kMaxSmem) return 0;
  auto kernel = scan_kernel<MODE, ROWS, QT, BLOOM_T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n / a.rows_per_block, (a.b + QT - 1) / QT);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  *launched = true;
  return (int)cudaGetLastError();
}

// 32 queries per block; 16 where shared memory runs out. At d = 768 the
// 16-query tile serves the 2048-bit bloom (K4 at sub 512, K5 at sub 1024) and
// the coarse scan at sub 2048; tests/test_torch_cuda.py holds both on the card.
template <int MODE, bool BLOOM_T = false>
int launch_mode(const Args& a, cudaStream_t stream) {
  bool launched = false;
  int rc = try_launch<MODE, 64, 32, BLOOM_T>(a, stream, &launched);
  if (launched || rc) return rc;
  rc = try_launch<MODE, 64, 16, BLOOM_T>(a, stream, &launched);
  if (launched || rc) return rc;
  return -1;  // no tile configuration fits this shape
}

// ---- T2: the pipelined coarse scan ----

constexpr int kPipeRows = 64;        // rows a row tile stages (K1's)
constexpr int kScoreWarps = 8;       // K1's eight warps score ...
constexpr int kExtractWarps = 4;     // ... while four more extract
constexpr int kScoreThreads = 32 * kScoreWarps;
constexpr int kPipeThreads = 32 * (kScoreWarps + kExtractWarps);
// named barriers (0 is __syncthreads'): the scoring warps' row tile, and per
// slot "scored" (scoring warps arrive, extraction warps wait) and "extracted"
// (the other way round)
constexpr int kBarTile = 1, kBarScored = 2, kBarExtracted = 4;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

inline size_t pipe_smem(int qt, int se, int sub) {
  return (size_t)qt * se + (size_t)kPipeRows * se + 2 * (size_t)qt * sub * 4;
}

// queries a block of T2 takes: 32 where the query tile, one row tile and two
// [QT][sub] score slots fit in shared memory, else 16 (sub 1024 at d = 768)
int pipe_tile(int se, int sub) {
  for (int qt = 32; qt >= 16; qt /= 2)
    if (pipe_smem(qt, se, sub) <= (size_t)kMaxSmem) return qt;
  return 0;
}

// Every thread passes every barrier of its side on every slice, whatever its
// queries: a warp skips a query past the batch end only inside extract_query's
// caller loop, which holds no barrier.
template <int QT>
__global__ void __launch_bounds__(kPipeThreads) pipe_kernel(Args a) {
  constexpr int RPT = kPipeRows / 32;
  constexpr int QPT = QT / kScoreWarps;    // queries a scoring warp scores
  constexpr int QPE = QT / kExtractWarps;  // queries an extraction warp extracts
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = a.sub;
  const long n_slices = a.n / sub;
  const int slices_per_block = a.rows_per_block / sub;
  const long slice0 = (long)blockIdx.x * slices_per_block;
  const int S = (int)min((long)slices_per_block, n_slices - slice0);
  const int q0 = blockIdx.y * QT;

  int8_t* qs = reinterpret_cast<int8_t*>(smem);
  int8_t* tile = qs + QT * a.se;
  float* slots = reinterpret_cast<float*>(tile + kPipeRows * a.se);  // [2][QT][sub]

  const int dv = a.d / 16;
  for (int i = tid; i < QT * dv; i += kPipeThreads) {
    const int qi = i / dv, v = i % dv;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + qi < a.b) val = reinterpret_cast<const int4*>(a.q8 + (size_t)(q0 + qi) * a.d)[v];
    reinterpret_cast<int4*>(qs + qi * a.se)[v] = val;
  }
  __syncthreads();

  if (warp < kScoreWarps) {
    float qsc[QPT], qb[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int qg = q0 + warp * QPT + j;
      qsc[j] = qg < a.b ? a.q_scale[qg] : 0.0f;
      qb[j] = qg < a.b ? a.q_bias[qg] : 0.0f;
    }
    for (int s = 0; s < S; ++s) {
      float* sc = slots + (size_t)(s & 1) * QT * sub;
      if (s >= 2) bar_sync(kBarExtracted + (s & 1), kPipeThreads);  // slice s - 2 is out
      const long r0 = (slice0 + s) * sub;
      for (int rt = 0; rt < sub; rt += kPipeRows) {
        bar_sync(kBarTile, kScoreThreads);  // previous tile consumed
        const int4* src = reinterpret_cast<const int4*>(a.emb8 + (r0 + rt) * a.d);
        for (int i = tid; i < kPipeRows * dv; i += kScoreThreads)
          reinterpret_cast<int4*>(tile + (i / dv) * a.se)[i % dv] = src[i];
        bar_sync(kBarTile, kScoreThreads);
        int acc[RPT][QPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc[i][j] = 0;
        dot_tile<RPT, QPT>(tile, a.se, qs, a.d, lane, warp, acc);
        // K1's epilogue (scan_kernel, MODE 0), written out: sharing it would touch
        // scan_kernel's code, whose register allocation moves on any change
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int rl = lane + 32 * i;
          const long r = r0 + rt + rl;
          const float ar = a.add_row[r], sr = a.scale_row[r];
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            float v = __fmaf_rn(__fmul_rn((float)acc[i][j], qsc[j]), sr, ar);
            v = __fadd_rn(__fadd_rn(v, qb[j]), kEpsInt8);
            sc[(warp * QPT + j) * sub + rt + rl] = v;
          }
        }
      }
      bar_arrive(kBarScored + (s & 1), kPipeThreads);  // slot s % 2 holds slice s
    }
  } else {
    const int ew = warp - kScoreWarps;
    for (int s = 0; s < S; ++s) {
      float* sc = slots + (size_t)(s & 1) * QT * sub;
      bar_sync(kBarScored + (s & 1), kPipeThreads);
      for (int j = 0; j < QPE; ++j) {
        const int ql = ew * QPE + j, qg = q0 + ql;
        if (qg >= a.b) continue;  // warp-uniform
        omni::extract_query(sc + ql * sub, sub, sub, a.t1, a.packed, (slice0 + s) * sub,
                            n_slices, qg, a.out_vals, a.out_idxs, lane);
      }
      // hand the slot back only if a slice is still to be scored into it
      if (s + 2 < S) bar_arrive(kBarExtracted + (s & 1), kPipeThreads);
    }
  }
}

template <int QT>
int launch_pipe(const Args& a, cudaStream_t stream) {
  const size_t smem = pipe_smem(QT, a.se, a.sub);
  auto kernel = pipe_kernel<QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long n_slices = a.n / a.sub;
  const int slices_per_block = a.rows_per_block / a.sub;
  dim3 grid((unsigned)((n_slices + slices_per_block - 1) / slices_per_block),
            (a.b + QT - 1) / QT);
  kernel<<<grid, kPipeThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omni_scan_topt(const void* emb8, const void* bloom, const void* q8,
                              const void* kw_w8, const void* kw_b, const void* add_row,
                              const void* scale_row, const void* q_scale, const void* q_bias,
                              void* out_vals, void* out_idxs, int n, int d, int w, int b,
                              int sub, int t1, int mode, int packed, void* stream) {
  Args a;
  a.emb8 = static_cast<const int8_t*>(emb8);
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.q8 = static_cast<const int8_t*>(q8);
  a.kw_w8 = static_cast<const int8_t*>(kw_w8);
  a.kw_b = static_cast<const float*>(kw_b);
  a.add_row = static_cast<const float*>(add_row);
  a.scale_row = static_cast<const float*>(scale_row);
  a.q_scale = static_cast<const float*>(q_scale);
  a.q_bias = static_cast<const float*>(q_bias);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_idxs);
  a.n = n; a.d = d; a.w = w; a.b = b; a.sub = sub; a.t1 = t1; a.packed = packed;
  a.rows_per_block = 0;
  a.se = mode != kKwOnly ? pad_stride(d) : 0;
  a.sk = mode != kCoarse ? pad_stride(8 * w) : 0;
  if (n <= 0 || b <= 0 || sub <= 0 || t1 <= 0 || t1 > sub || n % sub != 0) return -1;
  if (mode != kKwOnly && (d <= 0 || d % 16 != 0)) return -1;
  if (mode != kCoarse && (w <= 0 || w % 2 != 0)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCoarse: return launch_mode<kCoarse>(a, st);
    case kFused: return launch_mode<kFused>(a, st);
    case kKwOnly: return launch_mode<kKwOnly>(a, st);
    default: return -1;
  }
}

// T5: emb8 i8 [n, d], bloom u8 [n, w] (transposed = 0) or [w, n] (transposed = 1),
// q8 i8 [b, d], kw8 i8 [b, 8w], add f32 [n] -> out f32 [b, n / 512], the maximum
// score of each 512-row slice
extern "C" int omni_scan_probe(const void* emb8, const void* bloom, const void* q8,
                               const void* kw8, const void* add_row, void* out, int n, int d,
                               int w, int b, int transposed, void* stream) {
  Args a = {};
  a.emb8 = static_cast<const int8_t*>(emb8);
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.q8 = static_cast<const int8_t*>(q8);
  a.kw_w8 = static_cast<const int8_t*>(kw8);
  a.add_row = static_cast<const float*>(add_row);
  a.out_vals = static_cast<float*>(out);
  a.n = n; a.d = d; a.w = w; a.b = b; a.sub = 512; a.t1 = 1; a.packed = 0;
  a.se = pad_stride(d);
  a.sk = pad_stride(8 * w);
  if (n <= 0 || b <= 0 || n % a.sub != 0 || d <= 0 || d % 16 != 0 || w <= 0 || w % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transposed ? launch_mode<kProbe, true>(a, st) : launch_mode<kProbe, false>(a, st);
}

// T2: emb8 i8 [n, d], q8 i8 [b, d], add_row, scale_row f32 [n], q_scale (the 0.7
// cosine weight folded in), q_bias f32 [b] -> vals f32, idxs i32 [b, n / sub, t1],
// K1's contract; blocks of slices_per_block slices
extern "C" int omni_scan_pipe(const void* emb8, const void* q8, const void* add_row,
                              const void* scale_row, const void* q_scale, const void* q_bias,
                              void* out_vals, void* out_idxs, int n, int d, int b, int sub,
                              int t1, int packed, int slices_per_block, void* stream) {
  Args a = {};
  a.emb8 = static_cast<const int8_t*>(emb8);
  a.q8 = static_cast<const int8_t*>(q8);
  a.add_row = static_cast<const float*>(add_row);
  a.scale_row = static_cast<const float*>(scale_row);
  a.q_scale = static_cast<const float*>(q_scale);
  a.q_bias = static_cast<const float*>(q_bias);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_idxs);
  a.n = n; a.d = d; a.b = b; a.sub = sub; a.t1 = t1; a.packed = packed;
  if (n <= 0 || b <= 0 || d <= 0 || d % 16 != 0 || sub <= 0 || sub % kPipeRows != 0 ||
      n % sub != 0 || t1 <= 0 || t1 > sub || slices_per_block <= 0 ||
      (long)slices_per_block * sub > INT_MAX)
    return -1;
  a.rows_per_block = slices_per_block * sub;
  a.se = pad_stride(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pipe_tile(a.se, sub)) {
    case 32: return launch_pipe<32>(a, st);
    case 16: return launch_pipe<16>(a, st);
    default: return -1;
  }
}

// T2's query tile at this width and slice (0: none fits)
extern "C" int omni_scan_pipe_tile(int d, int sub) { return pipe_tile(pad_stride(d), sub); }

// T4: emb8 i8 [n, d], q8 i8 [b, d], scale f32 [n], qs f32 [b]; emit pair writes vals
// f32 and idxs i32 [n / c, b, (c / sub) * t1], P3 keys i32 in that layout (out_keys),
// PF keys i32 [b, (n / sub) * t1]. sub a power of two, c a multiple of sub.
extern "C" int omni_scan_keys_emit(const void* emb8, const void* q8, const void* scale,
                                   const void* qs, void* out_vals, void* out_keys, int n,
                                   int d, int b, int c, int sub, int t1, int emit,
                                   void* stream) {
  Args a = {};
  a.emb8 = static_cast<const int8_t*>(emb8);
  a.q8 = static_cast<const int8_t*>(q8);
  a.scale_row = static_cast<const float*>(scale);
  a.q_scale = static_cast<const float*>(qs);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_keys);
  a.n = n; a.d = d; a.b = b; a.sub = sub; a.t1 = t1; a.packed = 1;
  a.emit = emit;
  a.n_sub = sub > 0 ? c / sub : 0;
  a.se = pad_stride(d);
  if (n <= 0 || b <= 0 || d <= 0 || d % 16 != 0 || sub < 1 || (sub & (sub - 1)) != 0 ||
      c % sub != 0 || n % c != 0 || t1 <= 0 || t1 > sub || emit < kEmitPair || emit > kEmitPF)
    return -1;
  return launch_mode<kKeys>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
