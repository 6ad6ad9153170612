// Associative-memory similarity search, standalone.
//
// Replaces the TPU kernel src/repro/kernels/hdc_am/kernel.py::am_search_pallas
// (body _am_kernel):
//   overlap (mode 0): score[b, c] = popcount(q[b] & cls[c])
//   hamming (mode 1): score[b, c] = dim - popcount(q[b] ^ cls[c])
// for q (B, W) uint32, cls (C, W) uint32 -> (B, C) int32; the arithmetic is
// am.cuh's, which the encoders' AM epilogues share.
//
// Bound on this card: bytes (W words in per query, C ints out; one AND or
// XOR and one popcount per word).  At the main path's shape, (477, 32) x
// (2, 32), that is 65 kB, 0.00002 ms at 3.35 TB/s: far below the few
// microseconds any launch takes, so no body reaches the bound.  The offline
// pipeline scores inside the encoders instead (their AM epilogues); this
// kernel serves HDCPipeline.scores and retraining, which score frames they
// already hold.
//
// Design.  A group of R lanes takes one query row, lanes over words (R = 32,
// or the power of two >= W when W < 32, so a warp takes 32 / R rows): a
// row's words come in coalesced loads, neighbouring rows in neighbouring
// groups.  The class rows are staged once per block in shared memory, in
// chunks where they outgrow it (read from device memory where one row
// alone does); a lane sums the parts of AM_CT classes at a time in
// registers, and each class's sum is reduced across the group
// (__reduce_add_sync over a whole warp, shuffles within smaller groups).
// Any B, any C >= 1, any W; nothing is padded.
#include "common.cuh"
#include "am.cuh"

#define AM_THREADS 256
#define AM_CT 8                 // classes a lane sums at a time
#define AM_STAGE_BYTES 49152    // class rows staged a chunk (no opt-in needed)
#define AM_MAX_BLOCKS 4096

__global__ void __launch_bounds__(AM_THREADS) hdc_am_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ cls, int* __restrict__ out,
    long long B, int C, int W, int mode, int dim, int R, int cc, int staged) {
  extern __shared__ __align__(16) uint32_t cs[];  // cc class rows
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int G = 32 / R, grp = lane / R, gl = lane - grp * R;
  const long long step = (long long)gridDim.x * nwarps * G;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int ncc = min(cc, C - c0);
    const uint32_t* crows = cls + (long long)c0 * W;
    if (staged) {
      __syncthreads();  // the previous chunk is read
      for (int i = tid; i < ncc * W; i += nt) cs[i] = __ldg(crows + i);
      __syncthreads();
      crows = cs;
    }
    // rb: the warp's first row; uniform over the warp, so every lane takes
    // part in the reductions
    for (long long rb = ((long long)blockIdx.x * nwarps + warp) * G; rb < B; rb += step) {
      const long long row = rb + grp;
      const bool valid = row < B;
      const uint32_t* qr = q + row * W;
      for (int ct = 0; ct < ncc; ct += AM_CT) {
        int acc[AM_CT];
#pragma unroll
        for (int j = 0; j < AM_CT; ++j) acc[j] = 0;
        for (int w = gl; w < W; w += R) {
          const uint32_t qw = valid ? __ldg(qr + w) : 0u;
#pragma unroll
          for (int j = 0; j < AM_CT; ++j)
            if (ct + j < ncc) acc[j] += am_word(qw, crows[(ct + j) * W + w], mode);
        }
#pragma unroll
        for (int j = 0; j < AM_CT; ++j) {
          if (ct + j >= ncc) break;  // uniform over the warp
          int s = acc[j];
          if (R == 32) {
            s = __reduce_add_sync(0xffffffffu, s);
          } else {
            for (int o = R >> 1; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          }
          const int c = c0 + ct + j;
          if (valid && gl == (c & (R - 1))) out[row * C + c] = am_score(s, mode, dim);
        }
      }
    }
  }
}

HDC_EXPORT int hdc_am_launch(const void* q, const void* cls, void* out, long long B,
                             int C, int W, int mode, int dim, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (W <= 0 || (mode != AM_OVERLAP && mode != AM_HAMMING)) return (int)cudaErrorInvalidValue;
  int R = 1;
  while (R < W && R < 32) R <<= 1;
  const long long rows_per_block = (long long)(AM_THREADS / 32) * (32 / R);
  const long long need = (B + rows_per_block - 1) / rows_per_block;
  const unsigned grid = (unsigned)(need < AM_MAX_BLOCKS ? need : AM_MAX_BLOCKS);
  const long long row_bytes = (long long)W * 4;
  const int staged = row_bytes <= AM_STAGE_BYTES;
  const int cc = staged ? (int)(AM_STAGE_BYTES / row_bytes < C ? AM_STAGE_BYTES / row_bytes : C)
                        : C;
  const size_t smem = staged ? (size_t)cc * W * 4 : 0;
  hdc_am_kernel<<<grid, AM_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)cls, (int*)out, B, C, W, mode, dim, R, cc, staged);
  return (int)cudaGetLastError();
}
