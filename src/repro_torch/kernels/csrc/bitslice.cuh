// Bit-sliced counters: the per-bit counts of the 32 bit positions of a word
// kept as NP planes of uint32_t, plane i holding bit i of every position's
// count.  One word operation on the planes advances all 32 counts at once,
// where a per-bit counter spends 32 adds.
//
// * add8: eight words through a carry-save tree of seven full adders
//   (sum = a ^ b ^ c, carry = maj(a, b, c): one LOP3 each) into planes 0-2,
//   then the weight-8 carry rippled up from plane 3 (two operations a
//   plane): 14 + 2 (NP - 3) operations for eight words.
// * at_least(thr): the positions whose count >= thr, compared from the top
//   plane down with running "greater" and "equal" masks (three operations a
//   plane).  The strict majority 2 cnt > n is cnt >= n / 2 + 1 (integer
//   division), so ties give 0.
// * NP is chosen at launch: 8 planes count to 255 and 15 to 32767.  A count
//   never exceeds the number of words added, so the top carry is always 0.
#pragma once

#include <stdint.h>

// Bit length of a count of at most n: the plane count the launchers pick.
static inline int bitslice_planes(long long n) { return n <= 255 ? 8 : 15; }
#define BITSLICE_MAX_COUNT 32767

__device__ __forceinline__ void full_add(uint32_t& s, uint32_t a, uint32_t b,
                                         uint32_t& carry) {
  const uint32_t t = s;
  s = t ^ a ^ b;
  carry = (t & a) | (t & b) | (a & b);
}

template <int NP>
struct BitCounter {
  static_assert(NP >= 4, "add8 needs planes 0-3");
  uint32_t p[NP];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NP; ++i) p[i] = 0u;
  }

  // add x with weight 2^FROM
  template <int FROM>
  __device__ __forceinline__ void ripple(uint32_t x) {
#pragma unroll
    for (int i = FROM; i < NP; ++i) {
      const uint32_t c = p[i] & x;
      p[i] ^= x;
      x = c;
    }
  }

  __device__ __forceinline__ void add8(const uint32_t (&x)[8]) {
    uint32_t a1, b1, c1, d1, a2, b2, a3;
    full_add(p[0], x[0], x[1], a1);
    full_add(p[0], x[2], x[3], b1);
    full_add(p[0], x[4], x[5], c1);
    full_add(p[0], x[6], x[7], d1);
    full_add(p[1], a1, b1, a2);
    full_add(p[1], c1, d1, b2);
    full_add(p[2], a2, b2, a3);
    ripple<3>(a3);
  }

  // bits whose count >= thr (thr is uniform over the warp)
  __device__ __forceinline__ uint32_t at_least(int thr) const {
    if (thr <= 0) return 0xffffffffu;
    if (thr >= (1 << NP)) return 0u;
    uint32_t gt = 0u, eq = 0xffffffffu;
#pragma unroll
    for (int i = NP - 1; i >= 0; --i) {
      const uint32_t t = 0u - (uint32_t)((thr >> i) & 1);  // all ones where thr has bit i
      gt |= eq & p[i] & ~t;
      eq &= ~(p[i] ^ t);
    }
    return gt | eq;
  }
};
