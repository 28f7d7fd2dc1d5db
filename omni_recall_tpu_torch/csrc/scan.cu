// Hand-written Hopper (sm_90a) kernels for the int8 hybrid scans.
//
// One templated source serves three TPU kernels of omni_recall_tpu/ops/pallas_scorer.py:
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

enum Mode : int { kCoarse = 0, kFused = 1, kKwOnly = 2 };

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
  int n, d, w, b, sub, t1, packed;
  int rows_per_block;  // R
  int se, sk;          // shared row strides (bytes): emb rows, unpacked bloom rows
};

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

template <int MODE, int ROWS, int QT>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  constexpr bool kEmb = MODE != kKwOnly;
  constexpr bool kKw = MODE != kCoarse;
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
    qsc[j] = (kEmb && ok) ? a.q_scale[qg] : 0.0f;
    qb[j] = (MODE != kKwOnly && ok) ? a.q_bias[qg] : 0.0f;
    kb[j] = (kKw && ok) ? a.kw_b[qg] : 0.0f;
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
      for (int i = tid; i < ROWS * a.w; i += kThreads) {
        const int r = i / a.w, wd = i % a.w;
        const uint32_t byte = a.bloom[(tr0 + r) * a.w + wd];
        *reinterpret_cast<uint2*>(tile + r * a.sk + wd * 8) =
            make_uint2(expand4(byte & 15u), expand4(byte >> 4));
      }
      __syncthreads();
      dot_tile<RPT, QPT>(tile, a.sk, kws, 8 * a.w, lane, warp, acc_k);
    }

    // f32 epilogue in the JAX operation order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = lane + 32 * i;
      const long r = tr0 + rl;
      const float ar = a.add_row[r];
      const float sr = kEmb ? a.scale_row[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float s;
        if (MODE == kCoarse) {
          s = __fmaf_rn(__fmul_rn((float)acc_c[i][j], qsc[j]), sr, ar);
          s = __fadd_rn(__fadd_rn(s, qb[j]), kEpsInt8);
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
    omni::extract_query(sc + ql * R, R, a.sub, a.t1, a.packed, row0, n_slices, qg,
                        a.out_vals, a.out_idxs, lane);
  }
}

template <int MODE, int ROWS, int QT>
int try_launch(Args a, cudaStream_t stream, bool* launched) {
  if (a.sub % ROWS != 0 && ROWS % a.sub != 0) return 0;
  a.rows_per_block = a.sub > ROWS ? a.sub : ROWS;
  if (a.n % a.rows_per_block != 0) return 0;
  const bool emb = MODE != kKwOnly, kw = MODE != kCoarse;
  const int se = emb ? a.se : 0, sk = kw ? a.sk : 0;
  const int tile_stride = se > sk ? se : sk;
  const size_t smem = (emb ? (size_t)QT * a.se : 0) + (kw ? (size_t)QT * a.sk : 0) +
                      (size_t)ROWS * tile_stride + (size_t)QT * a.rows_per_block * 4;
  if (smem > (size_t)kMaxSmem) return 0;
  auto kernel = scan_kernel<MODE, ROWS, QT>;
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
template <int MODE>
int launch_mode(const Args& a, cudaStream_t stream) {
  bool launched = false;
  int rc = try_launch<MODE, 64, 32>(a, stream, &launched);
  if (launched || rc) return rc;
  rc = try_launch<MODE, 64, 16>(a, stream, &launched);
  if (launched || rc) return rc;
  return -1;  // no tile configuration fits this shape
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

extern "C" const char* omni_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
