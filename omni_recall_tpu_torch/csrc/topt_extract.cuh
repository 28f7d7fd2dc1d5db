// The per-slice top-(t1-1) + bound extraction of _extract_topt
// (omni_recall_tpu/ops/pallas_scorer.py), shared by the scans of scan.cu and
// fp_scan.cu. One warp extracts every slice of one query from the f32 scores
// a block holds in shared memory and writes the decoded [B, slices, t1]
// contract (vals f32, idxs i32, bound entries at index -2), in both of the
// JAX code's modes: packed keys when sub is a power of two and t1 >= 3, else
// the value/index two-reduce. The rounds are the literal max-and-mask rounds
// of the JAX code, so the output is bit for bit what the TPU kernels decode to.

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

// Extract every slice of one query. ``sc`` holds the query's scores for the
// block's R rows (global rows row0 .. row0 + R); it is overwritten. All 32
// lanes of the warp call this together.
__device__ void extract_query(float* sc, int R, int sub, int t1, int packed, long row0,
                              long n_slices, int qg, float* out_vals, int32_t* out_idxs,
                              int lane) {
  const int slices = R / sub;
  for (int sl = 0; sl < slices; ++sl) {
    float* ss = sc + sl * sub;
    const long base = row0 + (long)sl * sub;
    const size_t o = ((size_t)qg * n_slices + base / sub) * t1;
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
          out_vals[o + r] = decode_up(m, lmask);
          out_idxs[o + r] = (r == t1 - 1) ? -2 : (int)((lmask - (m & lmask)) + base);
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
            out_idxs[o + r] = -2;
          }
          break;
        }
        int hit = sub;  // lowest lane among ties
        for (int e = lane; e < sub; e += 32)
          if (ss[e] == v) hit = min(hit, e);
        hit = warp_min_i(hit);
        if (lane == 0) {
          out_vals[o + r] = v;
          out_idxs[o + r] = (int)(hit + base);
        }
        __syncwarp();
        if (hit < sub && lane == (hit & 31)) ss[hit] = kExtractNegInf;
        __syncwarp();
      }
    }
  }
}

}  // namespace omni
