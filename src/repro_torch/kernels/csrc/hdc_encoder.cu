// Fused sparse-HDC frame encoder (CompIM position domain).
//
// Replaces the TPU kernel src/repro/kernels/hdc_encoder/kernel.py::encoder_pallas
// (body _encoder_kernel).  Per (batch, frame) cell:
//   per cycle: bind (pos + elec) mod L, then OR over channels (or, with
//   spatial thinning, per-position channel count >= spatial_threshold);
//   over the window: count each of the D bits, keep count >= temporal
//   threshold, pack LSB-first (d = 32 w + b) into D / 32 words.
// Inputs: positions (N, window, C, S) uint8 (the IM gather runs before the
// launch), elec (C, S) uint8.  Output: (N, D / 32) uint32.
//
// Bound on this card: bytes (window * C * S position bytes in, D / 8 bytes
// out per frame; a few integer operations per byte).  The TPU body expands a
// (32, C, S, L) one-hot (~2 MiB) to keep the VPU busy; here nothing of that
// size exists.  Design: one block per frame; per cycle the threads over
// (c, s) set bit s*L + (pos+elec) mod L of a D-bit shared bitmap with
// atomicOr (with thinning: atomicAdd into a D-entry shared counter), and
// after one barrier each thread adds its bits into a D-entry shared int32
// counter bank.  The per-cycle scratch is triple-buffered: cycle t writes
// buffer t % 3 and clears buffer (t + 2) % 3, so one barrier per cycle
// suffices.  The final threshold + pack is one __ballot_sync per word.
#include "common.cuh"

__global__ void hdc_encoder_kernel(const uint8_t* __restrict__ pos,
                                   const uint8_t* __restrict__ elec,
                                   uint32_t* __restrict__ out, int window, int C,
                                   int S, int L, int temporal_threshold,
                                   int thinning, int spatial_threshold) {
  extern __shared__ int smem[];
  const int D = S * L;
  const int W = D / 32;
  const int CS = C * S;
  const int nspat = thinning ? D : W;  // scratch entries per buffer
  int* counts = smem;                  // D
  int* spat = smem + D;                // 3 * nspat
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long frame = blockIdx.x;
  const uint8_t* p = pos + frame * (long long)window * CS;

  for (int d = tid; d < D; d += nt) counts[d] = 0;
  for (int i = tid; i < 3 * nspat; i += nt) spat[i] = 0;
  __syncthreads();

  for (int t = 0; t < window; ++t) {
    int* cur = spat + (t % 3) * nspat;
    int* nxt2 = spat + ((t + 2) % 3) * nspat;
    const uint8_t* pt = p + (long long)t * CS;
    for (int i = tid; i < CS; i += nt) {
      int s = i % S;
      int bit = s * L + ((int)pt[i] + (int)elec[i]) % L;
      if (thinning)
        atomicAdd(&cur[bit], 1);
      else
        atomicOr((unsigned*)&cur[bit >> 5], 1u << (bit & 31));
    }
    __syncthreads();
    for (int d = tid; d < D; d += nt) {
      int on = thinning ? (cur[d] >= spatial_threshold)
                        : (int)((((unsigned)cur[d >> 5]) >> (d & 31)) & 1u);
      counts[d] += on;
    }
    // buffer (t + 2) % 3 was last read in cycle t - 1, which every thread
    // finished before this cycle's barrier; it is next written in cycle
    // t + 2, after the barrier of cycle t + 1
    for (int i = tid; i < nspat; i += nt) nxt2[i] = 0;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int w = warp; w < W; w += nwarps) {
    unsigned word = __ballot_sync(0xffffffffu, counts[w * 32 + lane] >= temporal_threshold);
    if (lane == 0) out[frame * W + w] = word;
  }
}

HDC_EXPORT int hdc_encoder_launch(const void* pos, const void* elec, void* out,
                                  long long n_frames, int window, int C, int S, int L,
                                  int temporal_threshold, int thinning,
                                  int spatial_threshold, void* stream) {
  if (n_frames <= 0) return 0;
  const int D = S * L;
  const int nspat = thinning ? D : D / 32;
  size_t smem = (size_t)(D + 3 * nspat) * sizeof(int);
  cudaError_t err = hdc_set_smem(hdc_encoder_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hdc_encoder_kernel<<<(unsigned)n_frames, 256, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)pos, (const uint8_t*)elec, (uint32_t*)out, window, C, S, L,
      temporal_threshold, thinning, spatial_threshold);
  return (int)cudaGetLastError();
}
