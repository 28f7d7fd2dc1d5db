// The per-slice top-(t1-1) + bound extraction of _extract_topt
// (omni_recall_tpu/ops/pallas_scorer.py), shared by the scans of scan.cu,
// fp_scan.cu and int8_scan.cu. One warp extracts every slice of one query
// from the f32 scores a block holds in shared memory and writes the decoded
// [B, slices, t1] contract (vals f32, idxs i32, bound entries at index -2),
// in both of the JAX code's modes: packed keys when sub is a power of two and
// t1 >= 3, else the value/index two-reduce. The rounds are the literal
// max-and-mask rounds of the JAX code, so the output is bit for bit what the
// TPU kernels decode to. extract_slices, the tensor-core scans' entry, holds
// each lane's scores of a slice in registers for slices of 128-1024 rows.

#pragma once

#include <climits>
#include <cstdint>

namespace omni {

constexpr float kExtractNegInf = -1e30f;  // _NEG_INF, the in-kernel mask value

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// packed key -> f32 upper bound with the lane bits forced to 1 (decode_up)
__device__ __forceinline__ float decode_up(int k, int lmask) {
  int y = k | lmask;
  y = y ^ ((y >> 31) & 0x7FFFFFFF);
  return __int_as_float(y);
}

// What a round writes: the decoded value (and index), or, in the packed
// mode, the raw packed key itself, into out_idxs (T4's P3 and PF emits).
enum Emit : int { kDecoded = 0, kRawKeys = 1 };

// Where the t1 entries of query qg's global slice `slice` start in the
// output: the [B, slices, t1] contract of the scans.
struct SliceMajor {
  __device__ __forceinline__ size_t operator()(int qg, long slice, long n_slices,
                                               int t1) const {
    return ((size_t)qg * n_slices + slice) * t1;
  }
};

// Extract every slice of one query. ``sc`` holds the query's scores for the
// block's R rows (global rows row0 .. row0 + R); it is overwritten. All 32
// lanes of the warp call this together. WRITE_IDXS = false writes the values
// alone (out_idxs unused): the profiling probes of the tools/ kernels.
// EMIT = kRawKeys writes the packed keys (packed mode only) and Offset places
// them: the emit layouts of T4.
template <bool WRITE_IDXS = true, int EMIT = kDecoded, class Offset = SliceMajor>
__device__ void extract_query(float* sc, int R, int sub, int t1, int packed, long row0,
                              long n_slices, int qg, float* out_vals, int32_t* out_idxs,
                              int lane, Offset offset = Offset()) {
  const int slices = R / sub;
  for (int sl = 0; sl < slices; ++sl) {
    float* ss = sc + sl * sub;
    const long base = row0 + (long)sl * sub;
    const size_t o = offset(qg, base / sub, n_slices, t1);
    if (packed) {
      const int lmask = sub - 1;
      int* ks = reinterpret_cast<int*>(ss);
      for (int e = lane; e < sub; e += 32) {
        const int si = __float_as_int(ss[e]);
        const int kf = si ^ ((si >> 31) & 0x7FFFFFFF);
        ks[e] = (kf & ~lmask) | (lmask - (e & lmask));
      }
      __syncwarp();
      for (int r = 0; r < t1; ++r) {
        int m = INT_MIN;
        for (int e = lane; e < sub; e += 32) m = max(m, ks[e]);
        m = warp_max_i(m);
        if (lane == 0) {
          if (EMIT == kRawKeys) {
            out_idxs[o + r] = m;
          } else {
            out_vals[o + r] = decode_up(m, lmask);
            if (WRITE_IDXS)
              out_idxs[o + r] = (r == t1 - 1) ? -2 : (int)((lmask - (m & lmask)) + base);
          }
        }
        if (r < t1 - 1)
          for (int e = lane; e < sub; e += 32)
            if (ks[e] == m) ks[e] = INT_MIN;
        __syncwarp();
      }
    } else {
      for (int r = 0; r < t1; ++r) {
        float v = __int_as_float(0xff800000);  // -inf
        for (int e = lane; e < sub; e += 32) v = fmaxf(v, ss[e]);
        v = warp_max_f(v);
        if (r == t1 - 1) {
          if (lane == 0) {
            out_vals[o + r] = v;
            if (WRITE_IDXS) out_idxs[o + r] = -2;
          }
          break;
        }
        int hit = sub;  // lowest lane among ties
        for (int e = lane; e < sub; e += 32)
          if (ss[e] == v) hit = min(hit, e);
        hit = warp_min_i(hit);
        if (lane == 0) {
          out_vals[o + r] = v;
          if (WRITE_IDXS) out_idxs[o + r] = (int)(hit + base);
        }
        __syncwarp();
        if (hit < sub && lane == (hit & 31)) ss[hit] = kExtractNegInf;
        __syncwarp();
      }
    }
  }
}

// The literal max-and-mask rounds of extract_query over slices of
// sub = 32 PER rows, with each lane's PER scores of a slice in registers:
// no shared-memory round trips inside the rounds. Same output,
// bit for bit: lane k holds rows lane + 32 k, so the lowest row among equal
// values is the lowest (k, lane). Lane r keeps round r's entry and the
// first t1 (<= 32) lanes store them together.
template <int PER, bool WRITE_IDXS>
static __device__ void extract_regs(const float* sc, int R, int t1, int packed, long row0,
                                    long n_slices, int qg, float* out_vals, int32_t* out_idxs,
                                    int lane) {
  constexpr int sub = 32 * PER;
  for (int sl = 0; sl < R / sub; ++sl) {
    const float* ss = sc + sl * sub;
    const long base = row0 + (long)sl * sub;
    const size_t o = ((size_t)qg * n_slices + base / sub) * t1;
    float my_v = 0.0f;
    int my_i = 0;
    if (packed) {
      constexpr int lmask = sub - 1;
      int key[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = lane + 32 * k;
        const int si = __float_as_int(ss[e]);
        const int kf = si ^ ((si >> 31) & 0x7FFFFFFF);
        key[k] = (kf & ~lmask) | (lmask - (e & lmask));
      }
      for (int r = 0; r < t1; ++r) {
        int m = key[0];
#pragma unroll
        for (int k = 1; k < PER; ++k) m = max(m, key[k]);
        m = warp_max_i(m);
        if (lane == r) {
          my_v = decode_up(m, lmask);
          my_i = (r == t1 - 1) ? -2 : (int)((lmask - (m & lmask)) + base);
        }
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (key[k] == m) key[k] = INT_MIN;
      }
    } else {
      float val[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) val[k] = ss[lane + 32 * k];
      for (int r = 0; r < t1; ++r) {
        float v = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int k = 0; k < PER; ++k) v = fmaxf(v, val[k]);
        v = warp_max_f(v);
        if (r == t1 - 1) {
          if (lane == r) { my_v = v; my_i = -2; }
          break;
        }
        int hit = sub;  // lowest row among ties
#pragma unroll
        for (int k = PER - 1; k >= 0; --k)
          if (val[k] == v) hit = lane + 32 * k;
        hit = warp_min_i(hit);
        if (lane == r) { my_v = v; my_i = (int)(hit + base); }
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (lane + 32 * k == hit) val[k] = kExtractNegInf;
      }
    }
    if (lane < t1) {
      out_vals[o + lane] = my_v;
      if (WRITE_IDXS) out_idxs[o + lane] = my_i;
    }
  }
}

// extraction of one query's R scores at slices of sub: in registers where
// sub is 128, 256, 512 or 1024 and t1 <= 32, else extract_query's rounds
// in shared memory (which overwrite the scores)
template <bool WRITE_IDXS>
static __device__ void extract_slices(float* sc, int R, int sub, int t1, int packed, long row0,
                                      long n_slices, int qg, float* out_vals,
                                      int32_t* out_idxs, int lane) {
  if (t1 <= 32) {
    switch (sub) {
      case 128: return extract_regs<4, WRITE_IDXS>(sc, R, t1, packed, row0, n_slices, qg,
                                                   out_vals, out_idxs, lane);
      case 256: return extract_regs<8, WRITE_IDXS>(sc, R, t1, packed, row0, n_slices, qg,
                                                   out_vals, out_idxs, lane);
      case 512: return extract_regs<16, WRITE_IDXS>(sc, R, t1, packed, row0, n_slices, qg,
                                                    out_vals, out_idxs, lane);
      case 1024: return extract_regs<32, WRITE_IDXS>(sc, R, t1, packed, row0, n_slices, qg,
                                                     out_vals, out_idxs, lane);
      default: break;
    }
  }
  extract_query<WRITE_IDXS>(sc, R, sub, t1, packed, row0, n_slices, qg, out_vals,
                            out_idxs, lane);
}

}  // namespace omni
