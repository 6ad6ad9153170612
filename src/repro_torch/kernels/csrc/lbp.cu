// Local-binary-pattern codes from raw iEEG samples.
//
// Replaces the TPU kernel src/repro/kernels/lbp/kernel.py::lbp_pallas
// (body _lbp_kernel):
//   code[b, t, c] = sum_i 2^i * [x[b, t+bits-i, c] > x[b, t+bits-i-1, c]]
// for x (B, T, C) float32 -> (B, T - bits, C) uint8.
//
// Bound on this card: bytes.  Each output byte needs bits + 1 input floats,
// but neighbouring outputs share them, so the least traffic is one read of x
// and one write of the codes (5 bytes per sample).  Design: one thread per
// output (b, t, c) with neighbouring threads on neighbouring channels, so
// every load and store of a warp is contiguous; the bits + 1 overlapping
// reads of a sample hit L1.  Shared memory has no VMEM-style limit to work
// around, so the reference wrapper's time chunking (MAX_CHUNK_T) is not
// needed: the whole time axis is one launch and the result is identical.
// Comparisons follow IEEE semantics (NaN compares false), as in JAX.
#include "common.cuh"

__global__ void lbp_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                           long long T, long long C, long long t_out, int bits,
                           long long total) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long c = i % C;
  long long bt = i / C;
  long long t = bt % t_out;
  long long b = bt / t_out;
  const float* xp = x + (b * T + t) * C + c;
  unsigned code = 0;
  for (int k = 0; k < bits; ++k) {
    float hi = xp[(long long)(bits - k) * C];
    float lo = xp[(long long)(bits - k - 1) * C];
    code |= (unsigned)(hi > lo) << k;
  }
  out[i] = (uint8_t)code;
}

HDC_EXPORT int lbp_codes_launch(const void* x, void* out, long long B, long long T,
                                long long C, int bits, void* stream) {
  long long t_out = T - bits;
  long long total = B * t_out * C;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  lbp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)out, T, C, t_out, bits, total);
  return (int)cudaGetLastError();
}

HDC_EXPORT const char* hdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
