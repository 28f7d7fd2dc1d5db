// Hand-written Hopper (sm_90a) kernel for the fused f32/bf16 hybrid scan, K6.
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
// x rounded to bf16 to nearest, ties to even (the kernel's astype(bfloat16)):
// a no-op for bf16 storage. Bit j of a bloom row is bit j / W of word j % W.
// The fused multiply-add of the epilogue sits where XLA's compiler contracts
// the JAX graph (found against the interpret-mode kernel on inputs whose dot
// products every summation order gives alike).
//
// Sum order: the TPU sums the dot products in its MXU's order, which nothing
// fixes. Here each (row, query) pair sums its terms in k order, one product
// and one f32 addition each (__fmul_rn, __fadd_rn; the library builds with
// -fmad=false): a product of two bf16 values is exact in f32 unless it
// underflows, and keeping the two roundings makes the result the plain
// version's (ops/scorer.py _seq_dot) bit for bit on every input. No wgmma or
// mma: their accumulation order is the hardware's.
//
// What bounds it on the H100: at the serving shapes (N = 2^20, d = 768,
// W = 128, B = 448) 2*N*B*(d + 8W) = 1.68e12 operations, 1.70 ms at the bf16
// tensor-core peak, against 1.75 GB (bf16 rows) or 3.36 GB (f32 rows) of
// reads, 0.52 / 1.00 ms at 3.35 TB/s: operation-bound. This first version
// runs on the CUDA cores in f32 (at best ~25 ms for the same operations at
// 67 TFLOP/s, and twice the instructions for the two roundings), far above
// that bound; tensor cores are later work.
//
// The same kernel serves the profiling probe T1 (tools/profile_kernel.py, the
// pallas_call at :26 with the bodies mk_cos_only :53, mk_cos_kw :60, mk_full
// :72), which splits this body three ways over bf16 rows and a block of c
// rows: T1-cos writes cos itself, T1-coskw the score without the eps,
//   score = fma(0.7, cos, 0.2 * kw) + add_row
// (the contraction found against the interpret-mode tool body, as for K6),
// both for the first 128 rows of each block ([N/c, B, 128]), and T1-full the
// nine largest scores of each block ([B, N/c, 9], values only: 8 max-and-mask
// rounds, lowest lane first, then the 9th maximum; extract_query's two-reduce
// mode with sub = c). Every variant computes all c rows of a block into
// shared memory, as the TPU body computes the whole [B, c] product: the probe
// measures that cost. A block then holds c scores a query, so the query tile
// drops to 16 at c = 2048 and to 8 at c = 4096. Bounds at N = 2^20, d = 768,
// W = 128, B = 448: cos 2*N*B*d = 7.2e11 operations, 0.73 ms at the bf16
// peak; coskw and full as K6, 1.70 ms.
//
// Design (scan.cu's frame): one block owns whole extraction slices
// (R = max(sub, ROWS) rows) for a tile of QT queries, so nothing carries
// between blocks. The block walks its rows ROWS at a time; for each row tile
// it streams the 768 cosine terms and then the 8W keyword terms in chunks of
// KC through shared memory, as f32 (rows rounded to bf16 and bloom bits
// unpacked to 0/1 on the way in, queries and keyword weights rounded to
// bf16), with a row stride of an odd number of 16-byte words so the 128-bit
// row loads of a warp are conflict free; the query loads are broadcasts. Each
// thread holds a 2-row x 4-query register tile of sums. The f32 scores of all
// R rows stay in shared memory for the extraction.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "topt_extract.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr int ROWS = 64;          // rows per tile (2 per lane)
constexpr int RPT = ROWS / 32;
constexpr int KC = 128;           // terms per shared-memory chunk
constexpr int KS = KC + 4;        // shared row stride in floats: 33 float4 words
constexpr float kEps = 8e-3f;     // PALLAS_CERT_EPS
constexpr float kCosW = 0.7f;     // COSINE_WEIGHT
constexpr float kKwW = 0.2f;      // KEYWORD_WEIGHT
constexpr int kT1Wide = 128;      // rows of a block T1-cos / T1-coskw write
constexpr int kT1Top = 9;         // values of a block T1-full writes

// what the kernel computes: K6, or one of the T1 probe's three bodies
enum Variant : int { kK6 = 0, kT1Cos = 1, kT1CosKw = 2, kT1Full = 3 };

struct Args {
  const void* emb;       // f32 or bf16 [n, d]
  const uint8_t* bloom;  // [n, w]
  const float* q;        // [b, d]
  const float* kw_w;     // [b, 8w]
  const float* kw_b;     // [b]
  const float* add_row;  // [n]
  float* out_vals;
  int32_t* out_idxs;
  int n, d, w, b, sub, t1, packed;
  int rows_per_block;    // R
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float row_term(const void* emb, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(emb)[i]);
  return bf16_round(static_cast<const float*>(emb)[i]);
}

// acc[i][j] += tile[lane + 32 i] . qs[warp * QPT + j] over kc terms, in order
template <int QPT>
__device__ __forceinline__ void chunk_dot(const float* tile, const float* qs, int kc, int lane,
                                          int warp, float (&acc)[RPT][QPT]) {
  for (int k = 0; k < kc; k += 4) {
    float4 rv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      rv[i] = *reinterpret_cast<const float4*>(tile + (lane + 32 * i) * KS + k);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * QPT + j) * KS + k);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float a = acc[i][j];
        a = __fadd_rn(a, __fmul_rn(qv.x, rv[i].x));
        a = __fadd_rn(a, __fmul_rn(qv.y, rv[i].y));
        a = __fadd_rn(a, __fmul_rn(qv.z, rv[i].z));
        a = __fadd_rn(a, __fmul_rn(qv.w, rv[i].w));
        acc[i][j] = a;
      }
    }
  }
}

template <bool BF16, int QT, int VAR = kK6>
__global__ void __launch_bounds__(kThreads) fp_scan_kernel(Args a) {
  constexpr bool kKw = VAR != kT1Cos;  // T1-cos has no keyword terms
  constexpr int QPT = QT / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [QT][KS] query terms of the chunk
  float* tile = qs + QT * KS;                  // [ROWS][KS] row terms of the chunk
  float* sc = tile + ROWS * KS;                // [QT][R] scores

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.rows_per_block;
  const long row0 = (long)blockIdx.x * R;
  const int q0 = blockIdx.y * QT;
  const int K = 8 * a.w;

  float kb[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qg = q0 + warp * QPT + j;
    kb[j] = qg < a.b ? a.kw_b[qg] : 0.0f;
  }

  for (int rt = 0; rt < R; rt += ROWS) {
    const long tr0 = row0 + rt;
    float acc_c[RPT][QPT], acc_k[RPT][QPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc_c[i][j] = acc_k[i][j] = 0.0f;

    // cosine terms
    for (int k0 = 0; k0 < a.d; k0 += KC) {
      const int kc = min(KC, a.d - k0);
      __syncthreads();  // previous chunk fully consumed
      for (int i = tid; i < ROWS * kc; i += kThreads) {
        const int r = i / kc, k = i % kc;
        tile[r * KS + k] = row_term<BF16>(a.emb, (size_t)(tr0 + r) * a.d + k0 + k);
      }
      for (int i = tid; i < QT * kc; i += kThreads) {
        const int qi = i / kc, k = i % kc;
        qs[qi * KS + k] = q0 + qi < a.b ? bf16_round(a.q[(size_t)(q0 + qi) * a.d + k0 + k]) : 0.0f;
      }
      __syncthreads();
      chunk_dot<QPT>(tile, qs, kc, lane, warp, acc_c);
    }
    // keyword terms: column j of the JAX bit matrix is bit j / W of word j % W
    for (int j0 = 0; kKw && j0 < K; j0 += KC) {
      const int kc = min(KC, K - j0);
      __syncthreads();
      for (int i = tid; i < ROWS * kc; i += kThreads) {
        const int r = i / kc, j = j0 + i % kc;
        const uint32_t byte = a.bloom[(size_t)(tr0 + r) * a.w + j % a.w];
        tile[r * KS + i % kc] = (float)((byte >> (j / a.w)) & 1u);
      }
      for (int i = tid; i < QT * kc; i += kThreads) {
        const int qi = i / kc, k = i % kc;
        qs[qi * KS + k] = q0 + qi < a.b ? bf16_round(a.kw_w[(size_t)(q0 + qi) * K + j0 + k]) : 0.0f;
      }
      __syncthreads();
      chunk_dot<QPT>(tile, qs, kc, lane, warp, acc_k);
    }

    // f32 epilogue in the JAX operation order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = lane + 32 * i;
      const float ar = a.add_row[tr0 + rl];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float s = acc_c[i][j];
        if (kKw) {
          const float kw = fminf(__fadd_rn(acc_k[i][j], kb[j]), 1.0f);
          s = __fadd_rn(__fmaf_rn(kCosW, s, __fmul_rn(kKwW, kw)), ar);
          if (VAR == kK6) s = __fadd_rn(s, kEps);
        }
        sc[(warp * QPT + j) * R + rt + rl] = s;
      }
    }
  }
  __syncthreads();

  // extraction, or T1's first 128 rows: warp `warp` owns queries warp * QPT + j
  const long n_slices = a.n / a.sub;
  for (int j = 0; j < QPT; ++j) {
    const int ql = warp * QPT + j, qg = q0 + ql;
    if (qg >= a.b) continue;  // warp-uniform
    if (VAR == kK6) {
      omni::extract_query(sc + ql * R, R, a.sub, a.t1, a.packed, row0, n_slices, qg,
                          a.out_vals, a.out_idxs, lane);
    } else if (VAR == kT1Full) {
      omni::extract_query<false>(sc + ql * R, R, R, kT1Top, 0, row0, n_slices, qg,
                                 a.out_vals, nullptr, lane);
    } else {
      float* o = a.out_vals + ((size_t)blockIdx.x * a.b + qg) * kT1Wide;
      for (int e = lane; e < kT1Wide; e += 32) o[e] = sc[ql * R + e];
    }
  }
}

constexpr size_t smem_bytes(int qt, int rows_per_block) {
  return ((size_t)(qt + ROWS) * KS + (size_t)qt * rows_per_block) * 4;
}

template <bool BF16, int QT, int VAR = kK6>
int try_launch(Args a, cudaStream_t stream, bool* launched) {
  const size_t smem = smem_bytes(QT, a.rows_per_block);
  if (smem > (size_t)kMaxSmem) return 0;
  auto kernel = fp_scan_kernel<BF16, QT, VAR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n / a.rows_per_block, (a.b + QT - 1) / QT);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  *launched = true;
  return (int)cudaGetLastError();
}

// 32 queries per block; 16 where the scores of a slice of 2048 rows do not fit
template <bool BF16>
int launch(const Args& a, cudaStream_t stream) {
  bool launched = false;
  int rc = try_launch<BF16, 32>(a, stream, &launched);
  if (launched || rc) return rc;
  rc = try_launch<BF16, 16>(a, stream, &launched);
  if (launched || rc) return rc;
  return -1;  // no tile configuration fits this shape
}

// T1's query tile for a block of c rows: the largest of 32, 16, 8 whose c
// scores a query fit beside the staging; 0 if none does
int probe_tile(int c) {
  for (int qt = 32; qt >= 8; qt /= 2)
    if (smem_bytes(qt, c) <= (size_t)kMaxSmem) return qt;
  return 0;
}

template <int VAR>
int launch_probe(const Args& a, cudaStream_t stream) {
  bool launched = false;
  switch (probe_tile(a.rows_per_block)) {
    case 32: return try_launch<true, 32, VAR>(a, stream, &launched);
    case 16: return try_launch<true, 16, VAR>(a, stream, &launched);
    case 8: return try_launch<true, 8, VAR>(a, stream, &launched);
    default: return -1;
  }
}

}  // namespace

extern "C" int omni_fp_scan_topt(const void* emb, const void* bloom, const void* q,
                                 const void* kw_w, const void* kw_b, const void* add_row,
                                 void* out_vals, void* out_idxs, int n, int d, int w, int b,
                                 int sub, int t1, int packed, int bf16, void* stream) {
  Args a;
  a.emb = emb;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.q = static_cast<const float*>(q);
  a.kw_w = static_cast<const float*>(kw_w);
  a.kw_b = static_cast<const float*>(kw_b);
  a.add_row = static_cast<const float*>(add_row);
  a.out_vals = static_cast<float*>(out_vals);
  a.out_idxs = static_cast<int32_t*>(out_idxs);
  a.n = n; a.d = d; a.w = w; a.b = b; a.sub = sub; a.t1 = t1; a.packed = packed;
  if (n <= 0 || b <= 0 || d <= 0 || d % 4 != 0 || w <= 0 || sub <= 0 || t1 <= 0 ||
      t1 > sub || n % sub != 0)
    return -1;
  if (sub % ROWS != 0 && ROWS % sub != 0) return -1;
  a.rows_per_block = sub > ROWS ? sub : ROWS;
  if (n % a.rows_per_block != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(a, st) : launch<false>(a, st);
}

// T1 over bf16 rows: variant 1 cos, 2 coskw (into out [N/c, B, 128]), 3 full
// (into out [B, N/c, 9]). Blocks of c rows, c % 64 == 0 (c >= 128 for 1, 2).
extern "C" int omni_fp_scan_probe(const void* emb, const void* bloom, const void* q,
                                  const void* kw_w, const void* kw_b, const void* add_row,
                                  void* out, int n, int d, int w, int b, int c, int variant,
                                  void* stream) {
  Args a;
  a.emb = emb;
  a.bloom = static_cast<const uint8_t*>(bloom);
  a.q = static_cast<const float*>(q);
  a.kw_w = static_cast<const float*>(kw_w);
  a.kw_b = static_cast<const float*>(kw_b);
  a.add_row = static_cast<const float*>(add_row);
  a.out_vals = static_cast<float*>(out);
  a.out_idxs = nullptr;
  a.n = n; a.d = d; a.w = w; a.b = b; a.sub = c; a.t1 = kT1Top; a.packed = 0;
  a.rows_per_block = c;
  if (n <= 0 || b <= 0 || d <= 0 || d % 4 != 0 || w <= 0 || c <= 0 || c % ROWS != 0 ||
      n % c != 0 || (variant != kT1Full && c < kT1Wide))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kT1Cos: return launch_probe<kT1Cos>(a, st);
    case kT1CosKw: return launch_probe<kT1CosKw>(a, st);
    case kT1Full: return launch_probe<kT1Full>(a, st);
    default: return -1;
  }
}

extern "C" int omni_fp_scan_probe_tile(int c) { return probe_tile(c); }

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
