// Local-binary-pattern codes from raw iEEG samples.
//
// Replaces the TPU kernel src/repro/kernels/lbp/kernel.py::lbp_pallas
// (body _lbp_kernel):
//   code[b, t, c] = sum_i 2^i * [x[b, t+bits-i, c] > x[b, t+bits-i-1, c]]
// for x (B, T, C) float32 -> (B, T - bits, C) uint8.
//
// Bound on this card: bytes.  Each output byte needs bits + 1 input floats,
// but neighbouring outputs share them, so the least traffic is one read of x
// and one write of the codes (5 bytes per sample): 52.4 MB at the main
// path's shape (4 records x 40960 samples x 64 channels), 0.0156 ms at
// 3.35 TB/s.
//
// Design: a thread owns 4 neighbouring channels and a run of LBP_RUN
// consecutive output steps.  It loads each sample of its run once, as a
// float4 (eight loads in flight), compares it with the previous one and
// shifts the 4 comparison bits into 4 codes kept as the bytes of one word:
// code = ((code << 1) & 0xfe..fe | bits_now) & mask, which drops the bit
// that falls out of the bits-wide window.  The first bits samples only warm
// the codes up (bits / LBP_RUN extra reads, from L2); each later sample
// stores 4 codes as one 32-bit word.  Neighbouring threads take
// neighbouring channel quads, so a warp's loads and stores are contiguous
// rows.  Index arithmetic is 32-bit and done once per thread; the run's
// pointers are 64-bit.  Where C is not a multiple of 4 (or x is not 16-byte
// aligned, or the codes not 4-byte aligned) the whole launch takes scalar
// loads and byte stores, the last quad masked to its channels; a run
// shorter than
// LBP_RUN ends the time axis.  Shared memory has no VMEM-style limit to
// work around, so the reference wrapper's time chunking (MAX_CHUNK_T) is
// not needed: the whole time axis is one launch and the result is
// identical.  Comparisons follow IEEE semantics (NaN compares false), as
// in JAX.
#include <limits.h>

#include "common.cuh"

#ifndef LBP_RUN
#define LBP_RUN 32
#endif
#ifndef LBP_BATCH
#define LBP_BATCH 8
#endif

template <bool VEC>
__device__ __forceinline__ float4 lbp_load(const float* p, int nc) {
  if constexpr (VEC) {
    return __ldg((const float4*)p);
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (nc > 0) v.x = __ldg(p);
    if (nc > 1) v.y = __ldg(p + 1);
    if (nc > 2) v.z = __ldg(p + 2);
    if (nc > 3) v.w = __ldg(p + 3);
    return v;
  }
}

template <bool VEC>
__device__ __forceinline__ void lbp_store(uint8_t* p, uint32_t codes, int nc) {
  if constexpr (VEC) {
    *(uint32_t*)p = codes;
  } else {
    for (int k = 0; k < nc; ++k) p[k] = (uint8_t)(codes >> (8 * k));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(256)
lbp_kernel(const float* __restrict__ x, uint8_t* __restrict__ out, int T, int C, int t_out,
           int bits, int Q, int nruns, int nthreads) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= nthreads) return;
  const int q = gid % Q, rr = gid / Q;
  const int b = rr / nruns, run = rr - b * nruns;
  const int t0 = run * LBP_RUN, c0 = 4 * q;
  const int nc = C - c0 < 4 ? C - c0 : 4;
  const int n = (t_out - t0 < LBP_RUN ? t_out - t0 : LBP_RUN) + bits;  // samples read
  const float* xp = x + ((long long)b * T + t0) * C + c0;
  uint8_t* op = out + ((long long)b * t_out + t0) * C + c0;
  const uint32_t keep = ((1u << bits) - 1u) * 0x01010101u;

  float4 prev = lbp_load<VEC>(xp, nc);
  uint32_t codes = 0u;
  for (int i0 = 1; i0 < n; i0 += LBP_BATCH) {
    float4 v[LBP_BATCH];
#pragma unroll
    for (int j = 0; j < LBP_BATCH; ++j)
      if (i0 + j < n) v[j] = lbp_load<VEC>(xp + (i0 + j) * C, nc);
#pragma unroll
    for (int j = 0; j < LBP_BATCH; ++j) {
      const int i = i0 + j;
      if (i < n) {
        const uint32_t d = (uint32_t)(v[j].x > prev.x) | (uint32_t)(v[j].y > prev.y) << 8 |
                           (uint32_t)(v[j].z > prev.z) << 16 | (uint32_t)(v[j].w > prev.w) << 24;
        codes = (((codes << 1) & 0xfefefefeu) | d) & keep;
        prev = v[j];
        if (i >= bits) lbp_store<VEC>(op + (i - bits) * C, codes, nc);
      }
    }
  }
}

HDC_EXPORT int lbp_codes_launch(const void* x, void* out, long long B, long long T,
                                long long C, int bits, void* stream) {
  const long long t_out = T - bits;
  if (B <= 0 || C <= 0 || t_out <= 0) return 0;
  const long long Q = (C + 3) / 4, nruns = (t_out + LBP_RUN - 1) / LBP_RUN;
  const long long nthreads = B * nruns * Q;
  if (bits < 1 || bits > 8 || T > INT_MAX || nthreads > INT_MAX ||
      (LBP_RUN + bits) * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 3) == 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((nthreads + threads - 1) / threads);
  if (vec)
    lbp_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (uint8_t*)out, (int)T, (int)C, (int)t_out, bits, (int)Q, (int)nruns,
        (int)nthreads);
  else
    lbp_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (uint8_t*)out, (int)T, (int)C, (int)t_out, bits, (int)Q, (int)nruns,
        (int)nthreads);
  return (int)cudaGetLastError();
}

HDC_EXPORT const char* hdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
