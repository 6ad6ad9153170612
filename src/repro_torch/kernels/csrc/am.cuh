// The associative-memory (AM) score of one frame against the class rows,
// shared by the standalone search (hdc_am.cu) and the AM epilogues of the
// two frame encoders (hdc_encoder.cu, dense_hdc.cu), so the arithmetic has
// one definition:
//   overlap (AM_OVERLAP): score[c] = sum over words w of popcount(q[w] & cls[c, w])
//   hamming (AM_HAMMING): score[c] = dim - sum over words w of popcount(q[w] ^ cls[c, w])
// and the prediction, the argmax over the classes with a tie going to the
// lower class index (repro.core.am.am_predict, jnp.argmax, torch.argmax).
// A caller sums am_word over its words however its threads own them; the
// sum becomes the score through am_score, and a warp turns a frame's sums
// into its scores and prediction with am_emit.
#pragma once

#include <stdint.h>

#define AM_OVERLAP 0
#define AM_HAMMING 1

// one word's part of a class's sum
__device__ __forceinline__ int am_word(uint32_t q, uint32_t c, int mode) {
  return __popc(mode == AM_OVERLAP ? (q & c) : (q ^ c));
}

// a class's score from the sum of its words' parts
__device__ __forceinline__ int am_score(int sum, int mode, int dim) {
  return mode == AM_OVERLAP ? sum : dim - sum;
}

// (v, i) beats (bv, bi): a larger score, or an equal one at a lower index
__device__ __forceinline__ bool am_better(int v, int i, int bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Called by a whole warp: sums[0..C) (any memory the warp can read) are a
// frame's per-class sums; writes scores[0..C) (when scores is not null) and
// *pred, the argmax with ties to the lower index.  Lane l takes classes l,
// l + 32, ...; the warp then keeps the best (score, class) pair.
__device__ __forceinline__ void am_emit(const int* sums, int C, int mode, int dim,
                                        int* scores, int* pred, int lane) {
  int bv = -2147483647 - 1, bi = 0x7fffffff;  // below any score
  for (int c = lane; c < C; c += 32) {
    const int v = am_score(sums[c], mode, dim);
    if (scores) scores[c] = v;
    if (am_better(v, c, bv, bi)) {
      bv = v;
      bi = c;
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, bv, s);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
    if (am_better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) *pred = bi;
}
