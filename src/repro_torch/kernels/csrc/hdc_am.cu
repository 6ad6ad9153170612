// Associative-memory similarity search.
//
// Replaces the TPU kernel src/repro/kernels/hdc_am/kernel.py::am_search_pallas
// (body _am_kernel):
//   overlap (mode 0): score[b, c] = popcount(q[b] & cls[c])
//   hamming (mode 1): score[b, c] = dim - popcount(q[b] ^ cls[c])
// for q (B, W) uint32, cls (C, W) uint32 -> (B, C) int32.
//
// Bound on this card: bytes (W words in per query, C ints out; one AND and
// one popcount per word).  The TPU kernel pads B to its 256-row block; here
// one thread per (query, class) sums __popc over the W words and the ragged
// batch edge is masked by the thread index, so nothing is padded or copied.
// The few class rows stay in L1 for the whole launch.
#include "common.cuh"

__global__ void hdc_am_kernel(const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ cls, int* __restrict__ out,
                              long long B, int C, int W, int mode, int dim) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  long long b = i / C;
  int c = (int)(i % C);
  const uint32_t* qp = q + b * W;
  const uint32_t* cp = cls + (long long)c * W;
  int s = 0;
  if (mode == 0) {
    for (int w = 0; w < W; ++w) s += __popc(qp[w] & cp[w]);
  } else {
    for (int w = 0; w < W; ++w) s += __popc(qp[w] ^ cp[w]);
    s = dim - s;
  }
  out[i] = s;
}

HDC_EXPORT int hdc_am_launch(const void* q, const void* cls, void* out, long long B,
                             int C, int W, int mode, int dim, void* stream) {
  long long total = B * C;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  hdc_am_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)cls, (int*)out, B, C, W, mode, dim);
  return (int)cudaGetLastError();
}
