// Fused dense-HDC frame encoder, with the item-memory gather inside.
//
// Replaces the TPU kernel src/repro/kernels/dense_hdc/kernel.py::dense_encoder_pallas
// (body _dense_kernel) together with the gather its wrapper runs just before
// it (dense_hdc/ops.py: item_packed[ch, codes]).  Per frame n:
//   per cycle t: bound[c] = item[c, min(codes[n, t, c], K - 1)] ^ elec[c],
//     spatial bit d = [2 * sum_c bit d of bound[c] > C]   (channel majority)
//   over the window: frame bit d = [2 * sum_t spatial bit d > window]
//   (temporal majority), packed LSB-first, d = 32 w + b.
// Both majorities are strict, so ties give 0, and every cycle of the window
// counts (the TPU body's 16-cycle chunk loop drops window % 16 cycles; the
// function computed here is the reference's dense_encoder_ref).
// Shapes: codes (N, window, C) uint8, item (C, K, W) uint32, elec (C, W)
// uint32 -> out (N, W) uint32.
//
// Bound on this card: operations.  One add per (frame, cycle, channel, bit)
// is 8 G at the main path's shape, against a few MB of codes, table and
// frames; the gathered (N, window, C, W) operand of the TPU kernel (1 GB
// there) never exists: the (C, K, W) table (512 KiB) stays in L2.
// Design (the simple first version): one block per (frame, group of eight
// words), eight warps, warp v owning word w = 8 * blockIdx.y + v and lane b
// owning bit b of it.  The frame's codes are staged, clamped, in shared
// memory a tile of cycles at a time; per (cycle, channel) the warp reads one
// table word (a broadcast load; the channel loop is unrolled so that several
// are in flight), XORs the electrode word and each lane adds its bit to a
// channel counter; the channel majority adds into the lane's
// temporal counter, and one __ballot_sync per word packs the frame.  A
// bit-sliced carry-save adder over the channels would do the per-bit count
// for all 32 lanes' bits in a few word operations per channel.
#include "common.cuh"

#define DENSE_TILE_BYTES 16384
#define DENSE_WARPS 8

__global__ void dense_hdc_kernel(const uint8_t* __restrict__ codes,
                                 const uint32_t* __restrict__ item,
                                 const uint32_t* __restrict__ elec,
                                 uint32_t* __restrict__ out, int window, int C,
                                 int K, int W, int tile_t) {
  __shared__ uint8_t sc[DENSE_TILE_BYTES];
  const long long frame = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * DENSE_WARPS + (threadIdx.x >> 5);
  const bool active = w < W;  // uniform over the warp
  const uint8_t* fc = codes + frame * (long long)window * C;

  int tcount = 0;
  for (int t0 = 0; t0 < window; t0 += tile_t) {
    const int nt = min(tile_t, window - t0);
    __syncthreads();  // every warp has finished the previous tile
    for (int i = threadIdx.x; i < nt * C; i += blockDim.x) {
      const int v = fc[(long long)t0 * C + i];
      sc[i] = (uint8_t)(v < K ? v : K - 1);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const uint8_t* row = sc + t * C;
        int cnt = 0;
#pragma unroll 8
        for (int c = 0; c < C; ++c) {
          const unsigned word = __ldg(item + ((long long)c * K + row[c]) * W + w) ^
                                __ldg(elec + (long long)c * W + w);
          cnt += (int)((word >> lane) & 1u);
        }
        tcount += (2 * cnt > C);
      }
    }
  }
  const unsigned packed = __ballot_sync(0xffffffffu, 2 * tcount > window);
  if (active && lane == 0) out[frame * W + w] = packed;
}

HDC_EXPORT int dense_hdc_launch(const void* codes, const void* item,
                                const void* elec, void* out, long long n_frames,
                                int window, int C, int K, int W, void* stream) {
  if (n_frames <= 0) return 0;
  if (C <= 0 || C > DENSE_TILE_BYTES || K <= 0 || W <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  const int tile_t = window < DENSE_TILE_BYTES / C ? window : DENSE_TILE_BYTES / C;
  const dim3 grid((unsigned)n_frames, (unsigned)((W + DENSE_WARPS - 1) / DENSE_WARPS));
  dense_hdc_kernel<<<grid, DENSE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint32_t*)item, (const uint32_t*)elec,
      (uint32_t*)out, window, C, K, W, tile_t);
  return (int)cudaGetLastError();
}
