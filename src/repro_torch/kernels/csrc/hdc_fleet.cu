// Fused code-domain fleet step: table gather + spatial bundle + bit
// transpose + masked-popcount temporal counters.
//
// Replaces the TPU kernel src/repro/kernels/hdc_fleet/kernel.py::fleet_counts_pallas
// (bodies _fleet_kernel and _spatial_bundle).  For session s with bank row
// o = owner[s] and each 32-cycle group g:
//   rows[j, c] = tables[o, c, min(codes[s, 32g + j, c], K - 1)]   (j < 32)
//   spatial[j] = OR_c rows (mode 0) | [sum_c bit >= thr] (mode 1, thin) |
//                [2 * sum_c bit > n] (mode 2, majority)
//   with an optional (S, C) channel mask: rows are multiplied by the mask
//   and the thin / majority denominators renormalise to the live count;
//   out[s, k, 32 w + b] += popcount(plane[b, w] & tm[s, k, g])
// where plane[b, w] bit j = bit b of spatial[j][w].  Shapes: tables
// (P, C, K, W) uint32, owner (S,) int32, codes (S, T32, C) uint8, tm
// (S, K1, T32 / 32) uint32, chan_mask (S, C) uint32 or null -> out
// (S, K1, 32 W) int32.
//
// Bound on this card: the DRAM bytes counted once (codes, tables, masks,
// counts) give a bound far below what the table gather moves: every
// (cycle, channel) reads one W-word bound row, W * 4 bytes, from the bank.
// At paper geometry one patient's bank is 1 MiB, more than the 227 KB of
// shared memory of an SM, so the TPU's VMEM-resident bank does not carry
// over; the whole 16-patient bank (16 MiB) instead stays resident in the
// 50 MB L2 and rows are gathered through it.  Design: the TPU grid
// accumulates over the sequential group axis into one output block; blocks
// here run in no order, so one block owns one session and loops over its
// groups.  Threads over (cycle j, word w), w fastest, read whole bound rows
// with contiguous loads and bundle over the channels in registers; a warp
// per word then holds the 32 cycles' words, one __ballot_sync per bit
// plane b is exactly hv.bit_transpose32's LSB-first cycle order, and lane b
// keeps plane b and adds its masked popcounts into the (K1, 32, W) shared
// counter bank, which it alone owns.  Codes past a session's length are
// masked off by tm; out-of-alphabet codes clamp within their channel.
#include "common.cuh"

__global__ void hdc_fleet_kernel(const uint32_t* __restrict__ tables,
                                 const int* __restrict__ owner,
                                 const uint8_t* __restrict__ codes,
                                 const uint32_t* __restrict__ tm,
                                 const uint32_t* __restrict__ chan_mask,
                                 int* __restrict__ out, int T32, int C, int K, int W,
                                 int K1, int P, int mode, int threshold) {
  extern __shared__ uint32_t sm[];
  int* acc = (int*)sm;                       // K1 * 32 * W
  uint32_t* sp = sm + K1 * 32 * W;           // 32 * W spatial words
  uint32_t* tmw = sp + 32 * W;               // K1 slot masks of this group
  uint32_t* cm = tmw + K1;                   // C channel mask words
  uint8_t* ctile = (uint8_t*)(cm + C);       // 32 * C codes of this group

  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = T32 / 32;
  int o = owner[s];
  o = o < 0 ? 0 : (o >= P ? P - 1 : o);
  const uint32_t* tab = tables + (long long)o * C * K * W;

  for (int i = tid; i < K1 * 32 * W; i += nt) acc[i] = 0;
  for (int c = tid; c < C; c += nt) cm[c] = chan_mask ? chan_mask[(long long)s * C + c] : 1u;
  __syncthreads();
  int live = C;
  if (chan_mask) {
    live = 0;
    for (int c = 0; c < C; ++c) live += (int)cm[c];
  }
  int thr = threshold;
  if (mode == 1 && chan_mask) {
    thr = (threshold * live + C - 1) / C;
    thr = thr < 1 ? 1 : thr;
  }
  const int denom = chan_mask ? live : C;

  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int g = 0; g < G; ++g) {
    const uint8_t* cg = codes + ((long long)s * T32 + (long long)g * 32) * C;
    for (int i = tid; i < 32 * C; i += nt) ctile[i] = cg[i];
    for (int k = tid; k < K1; k += nt) tmw[k] = tm[((long long)s * K1 + k) * G + g];
    __syncthreads();

    for (int i = tid; i < 32 * W; i += nt) {
      const int j = i / W, w = i - j * W;
      const uint8_t* cj = ctile + j * C;
      uint32_t word = 0;
      if (mode == 0) {
        for (int c = 0; c < C; ++c) {
          int code = min((int)cj[c], K - 1);
          word |= tab[((long long)c * K + code) * W + w] * cm[c];
        }
      } else {
        int cnt[32];
#pragma unroll
        for (int b = 0; b < 32; ++b) cnt[b] = 0;
        for (int c = 0; c < C; ++c) {
          int code = min((int)cj[c], K - 1);
          uint32_t v = tab[((long long)c * K + code) * W + w] * cm[c];
#pragma unroll
          for (int b = 0; b < 32; ++b) cnt[b] += (v >> b) & 1u;
        }
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          bool keep = mode == 1 ? cnt[b] >= thr : 2 * cnt[b] > denom;
          word |= (uint32_t)keep << b;
        }
      }
      sp[j * W + w] = word;
    }
    __syncthreads();

    for (int w = warp; w < W; w += nwarps) {
      uint32_t v = sp[lane * W + w];
      uint32_t mine = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        uint32_t plane = __ballot_sync(0xffffffffu, (v >> b) & 1u);
        if (lane == b) mine = plane;
      }
      for (int k = 0; k < K1; ++k) acc[(k * 32 + lane) * W + w] += __popc(mine & tmw[k]);
    }
    __syncthreads();
  }

  const int D = 32 * W;
  int* os = out + (long long)s * K1 * D;
  for (int i = tid; i < K1 * D; i += nt) {
    const int k = i / D, d = i - k * D;
    os[i] = acc[(k * 32 + (d & 31)) * W + (d >> 5)];
  }
}

HDC_EXPORT int hdc_fleet_launch(const void* tables, const void* owner, const void* codes,
                                const void* tm, const void* chan_mask, void* out, int S,
                                int T32, int C, int K, int W, int K1, int P, int mode,
                                int threshold, void* stream) {
  if (S <= 0) return 0;
  size_t smem = (size_t)(K1 * 32 * W + 32 * W + K1 + C) * sizeof(uint32_t) + 32 * C;
  cudaError_t err = hdc_set_smem(hdc_fleet_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hdc_fleet_kernel<<<S, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)tables, (const int*)owner, (const uint8_t*)codes,
      (const uint32_t*)tm, (const uint32_t*)chan_mask, (int*)out, T32, C, K, W, K1, P,
      mode, threshold);
  return (int)cudaGetLastError();
}
