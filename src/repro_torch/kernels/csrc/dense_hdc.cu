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
// Bound on this card: operations.  The least work is one word operation per
// (frame, cycle, channel, word) -- on bit-sliced counter planes one word
// operation advances the counts of 32 bit positions -- and one per (frame,
// cycle, word) for the temporal count: 0.25 G at the main path's shape (477
// frames x 256 cycles, C = 64, W = 32), 0.0038 ms at 67 T/s, against 8.4 MB
// of codes, table and frames (0.0025 ms).  The gathered (N, window, C, W)
// operand of the TPU kernel (1 GB there) never exists: the (C, K, W) table
// (512 KiB) stays in L2.
//
// Design.  A block takes one frame and one tile of up to 32 words and walks
// the window in passes of RC x 16 cycles.
// * Staged slabs.  A pass sweeps the channels an octet at a time: the
//   octet's slab of the table (8 channels x 64 codes x 32 words, 64 KiB,
//   contiguous) comes into shared memory by TMA bulk copies completing on
//   an mbarrier, double-buffered, so the table crosses from L2 once per
//   128 cycles (0.5 GB at the main shape, against 1 GB of 128 B row
//   gathers).  Each step issues the next step's slab, across passes; the
//   next pass's codes come by cp.async a pass ahead and are clamped to
//   K - 1 once, in place.
// * Bit-sliced counters.  A warp carries RC cycles; a half-warp takes every
//   other cycle and each lane two adjacent words, read with one 64-bit load
//   a (cycle, channel) (codes broadcast from shared memory).  Per octet the
//   lane loads its electrode words, XORs them in and adds the words to the
//   cycle's counters (bitslice.cuh: a carry-save tree, 3 operations a word
//   at 8 planes); one top-down compare, cnt >= C / 2 + 1, gives the spatial
//   word.
// * Temporal majority.  The pass's spatial words go to shared memory; a
//   warp per word transposes 32 cycles (warp_transpose32: five shuffle
//   stages) and lane b adds __popc of plane b into the word's per-bit
//   count.  Cycles past the window are zero words, so a window that is no
//   multiple of 32 needs no other mask.
// Planes: 8 (RC = 8) up to C = 255, 15 (RC = 4) up to C = 16384.  Where
// shared memory runs out the word tile narrows (K up to 256 codes are
// staged; slabs that are not one contiguous range are copied word by word
// with cp.async) and then the warps a block takes: any window, any W, C up
// to 16384.
//
// Codes may be a strided batch (frames [r * fpr, (r + 1) * fpr) contiguous
// from byte r * pitch), so frame_view of a (B, T, C) stream is read where it
// lies, never copied.
//
// AM epilogue, hamming mode (replaces src/repro/kernels/hdc_am/kernel.py::
// am_search_pallas and the argmax on the offline path): given (ncls, W)
// class rows, the warp that packs a word adds that word's part of each
// class's distance (am.cuh) into the tile's sums in shared memory.  A block
// owns a whole frame while W <= its tile (the main path: W = 32, one tile);
// it then writes the frame's scores and prediction itself.  Where a frame's
// tiles lie in several blocks (D = 2048 and up), each block adds its sums
// into the frame's row of a scratch buffer (ncls sums and a ticket, zeroed
// by the launcher on the same stream), fences, and takes a ticket; the
// block that takes the last one reads the whole sums and writes the scores
// and the prediction.  The frame words are then written only if asked for.
#include "common.cuh"
#include "am.cuh"
#include "bitslice.cuh"

#define DENSE_MAX_WARPS 16
#define DENSE_MAX_C 16384
#define DENSE_SP 33  // spatial words a cycle in shared memory: 32 + 1 against bank conflicts

// shared words before the slabs: two slab mbarriers, per-bit temporal
// counts of the tile's 32
// words, the pass's spatial words; a multiple of four, so the slabs are
// 16-byte aligned.  Two passes' codes follow the two slabs.
__host__ __device__ static inline size_t dense_head_words(int rows) {
  return ((size_t)4 + 32 * 32 + (size_t)rows * DENSE_SP + 3) & ~(size_t)3;
}

// The AM epilogue's operands: ncls class rows (or none), the outputs, and
// the (n_frames, ncls + 1) scratch rows of frames split across tiles.
struct DenseAM {
  const uint32_t* cls;
  int* scores;
  int* preds;
  int* scratch;
  int ncls;
};

template <int NP, int RC>
__global__ void __launch_bounds__(DENSE_MAX_WARPS * 32, 1)
dense_hdc_kernel(const uint8_t* __restrict__ codes, const uint32_t* __restrict__ item,
                 const uint32_t* __restrict__ elec, uint32_t* __restrict__ out,
                 int window, int C, int K, int W, int C8, int wn, int flat,
                 int codes16, uint32_t kmax4, long long fpr, long long pitch,
                 const DenseAM am) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int rows = nwarps * RC;  // cycles a pass
  const int Kc = K < 256 ? K : 256;
  const int ws = wn + (wn & 1);  // slab row stride, even
  const size_t slab = slab_words(K, ws);
  uint64_t* bars = (uint64_t*)sm;                         // 2 slab mbarriers
  int* tcnt = (int*)(sm + 4);                             // 32 words x 32 bits
  uint32_t* sp = sm + 4 + 32 * 32;                        // rows x DENSE_SP
  uint32_t* slabs = sm + dense_head_words(rows);          // 2 x slab
  uint8_t* ctile = (uint8_t*)(slabs + 2 * slab);          // 2 x rows x C8
  int* scs = (int*)(ctile + 2 * rows * C8);               // ncls AM sums, one flag

  const long long n = blockIdx.x;
  // Warp v carries RC cycles from r0; half-warp h (lane = 16 h + p) takes
  // cycles r0 + h, r0 + h + 2, ... and words w0 + 2p, w0 + 2p + 1.
  constexpr int RL = RC / 2;  // cycles a lane carries
  const int h = lane >> 4, pw = 2 * (lane & 15);
  const int w0 = blockIdx.y * wn, wcount = min(wn, W - w0);
  const bool wa = pw < wcount, wb = pw + 1 < wcount;
  const long long brow = n / fpr;
  const uint8_t* fc = codes + brow * pitch + (n - brow * fpr) * window * C;
  for (int i = tid; i < 32 * 32; i += nt) tcnt[i] = 0;
  for (int i = tid; i < am.ncls; i += nt) scs[i] = 0;
  for (int i = tid; i < 2 * rows * C8; i += nt) ctile[i] = 0;  // pad bytes stay 0
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init_fence();
  }
  __syncthreads();  // before any copy lands there
  const int thr = C / 2 + 1;                                // 2 cnt > C
  const int nocts = C8 / 8;
  const int r0 = warp * RC;

  // the codes of the pass from cycle t into buffer bf, a pass ahead: in
  // 16-byte cp.async pieces where the rows allow (clamped in place once
  // they are in: clamp_pass), else byte by byte, clamped
  auto stage_pass = [&](int t, int bf) {
    const int m = min(rows, window - t) * C;
    const uint8_t* src = fc + (long long)t * C;
    uint8_t* dst = ctile + bf * rows * C8;
    if (codes16) {
      for (int i = tid; i < m / 16; i += nt) cp_async16(dst + 16 * i, src + 16 * i);
    } else {
      for (int i = tid; i < m; i += nt) {
        const int r = i / C, c = i - r * C;
        const int v = src[i];
        dst[r * C8 + c] = (uint8_t)(v < K ? v : K - 1);
      }
    }
  };
  auto clamp_pass = [&](int bf) {
    if (!codes16 || kmax4 == 0xffffffffu) return;
    uint32_t* ct = (uint32_t*)(ctile + bf * rows * C8);
    for (int i = tid; i < rows * C8 / 4; i += nt) ct[i] = __vminu4(ct[i], kmax4);
  };
  // The steps (pass, octet) form one pipeline: each step issues the next
  // step's slab, across passes, so the first slab of a pass is in flight
  // during the previous temporal stage.
  int bf = 0;        // the slab buffer of the current step
  unsigned ph = 0u;  // bit b: the parity of slab buffer b's next completion
  stage_pass(0, 0);
  stage_slab(slabs, item, 0, C, K, W, Kc, w0, wn, ws, flat, bars);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  clamp_pass(0);
  for (int t0 = 0, pass = 0; t0 < window; t0 += rows, ++pass) {
    const int nr = min(rows, window - t0);
    const int pb = pass & 1;
    const uint8_t* crow = ctile + (pb * rows + r0 + h) * C8;
    const bool last_pass = t0 + rows >= window;
    if (!last_pass) stage_pass(t0 + rows, pb ^ 1);  // committed with the first step

    BitCounter<NP> cnt[RL][2];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      cnt[i][0].clear();
      cnt[i][1].clear();
    }
    for (int oc = 0; oc < nocts; ++oc) {
      if (oc + 1 < nocts || !last_pass)
        stage_slab(slabs + (bf ^ 1) * slab, item, oc + 1 < nocts ? 8 * (oc + 1) : 0, C, K,
                   W, Kc, w0, wn, ws, flat, bars + (bf ^ 1));
      cp_async_commit();
      cp_async_wait<1>();
      if (flat) {
        mbar_wait(bars + bf, (ph >> bf) & 1u);
        ph ^= 1u << bf;
      }
      __syncthreads();  // the slab of this step (and the pass's codes) are in
      if (r0 < nr && wa) {  // r0 < nr is uniform over the warp
        const uint32_t* sl = slabs + bf * slab + pw;
        const int c8 = 8 * oc;
        uint32_t e0[8], e1[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint32_t* ec = elec + (long long)(c8 + q) * W + w0 + pw;
          e0[q] = c8 + q < C ? __ldg(ec) : 0u;
          e1[q] = c8 + q < C && wb ? __ldg(ec + 1) : 0u;
        }
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const uint2 cc = *(const uint2*)(crow + 2 * i * C8 + c8);
          uint32_t x0[8], x1[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const uint32_t code = ((q < 4 ? cc.x : cc.y) >> (8 * (q & 3))) & 0xffu;
            uint2 v = make_uint2(0u, 0u);
            if (c8 + q < C) v = *(const uint2*)(sl + (q * Kc + code) * ws);
            x0[q] = c8 + q < C ? v.x ^ e0[q] : 0u;
            x1[q] = c8 + q < C ? v.y ^ e1[q] : 0u;
          }
          cnt[i][0].add8(x0);
          cnt[i][1].add8(x1);
        }
      }
      __syncthreads();  // every warp is done with the slab before it is refilled
      bf ^= 1;
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int r = r0 + 2 * i + h;
      sp[r * DENSE_SP + pw] = r < nr && wa ? cnt[i][0].at_least(thr) : 0u;
      sp[r * DENSE_SP + pw + 1] = r < nr && wb ? cnt[i][1].at_least(thr) : 0u;
    }
    cp_async_wait<0>();  // the next pass's codes
    __syncthreads();
    if (!last_pass) clamp_pass(pb ^ 1);  // read after the next pass's first barrier

    for (int ww = warp; ww < wcount; ww += nwarps) {  // uniform over the warp
      int add = 0;
      for (int ch = 0; ch < nr; ch += 32) {
        const uint32_t v = ch + lane < rows ? sp[(ch + lane) * DENSE_SP + ww] : 0u;
        add += __popc(warp_transpose32(v, lane));
      }
      tcnt[ww * 32 + lane] += add;
    }
  }
  __syncthreads();

  for (int ww = warp; ww < wcount; ww += nwarps) {
    const unsigned packed = __ballot_sync(0xffffffffu, 2 * tcnt[ww * 32 + lane] > window);
    if (lane == 0 && out) out[n * W + w0 + ww] = packed;
    for (int c = lane; c < am.ncls; c += 32)
      atomicAdd(&scs[c], am_word(packed, __ldg(am.cls + (long long)c * W + w0 + ww), AM_HAMMING));
  }
  if (!am.ncls) return;
  __syncthreads();  // the tile's sums are complete
  const int dim = 32 * W;
  if (gridDim.y == 1) {  // the block owns the frame
    if (warp == 0)
      am_emit(scs, am.ncls, AM_HAMMING, dim, am.scores + n * am.ncls, am.preds + n, lane);
    return;
  }
  int* row = am.scratch + n * (am.ncls + 1);  // ncls sums, then the ticket
  for (int c = tid; c < am.ncls; c += nt) atomicAdd(&row[c], scs[c]);
  __threadfence();  // the sums are visible before the ticket is taken
  __syncthreads();
  int* last = scs + am.ncls;
  if (tid == 0) *last = atomicAdd(&row[am.ncls], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int c = tid; c < am.ncls; c += nt) scs[c] = __ldcg(&row[c]);  // the frame's whole sums
  __syncthreads();
  if (warp == 0)
    am_emit(scs, am.ncls, AM_HAMMING, dim, am.scores + n * am.ncls, am.preds + n, lane);
}

template <int NP, int RC>
static int dense_launch(const void* codes, const void* item, const void* elec, void* out,
                        long long n_frames, int window, int C, int K, int W, long long fpr,
                        long long pitch, const DenseAM& am, cudaStream_t stream) {
  const int C8 = (C + 7) & ~7;
  // the widest word tile, then the most warps, that fit in shared memory
  size_t smem = 0;
  int warps = 0, wn = W < 32 ? W : 32;
  for (; wn >= 1; wn = wn > 1 ? (wn + 1) / 2 : 0) {
    for (int v = DENSE_MAX_WARPS; v >= 1; --v) {
      smem = (dense_head_words(v * RC) + 2 * slab_words(K, wn + (wn & 1))) * 4 +
             (size_t)2 * v * RC * C8 + (size_t)(am.ncls + 1) * 4;
      if (smem <= HDC_MAX_SMEM) {
        warps = v;
        break;
      }
    }
    if (warps) break;
  }
  if (!warps) return (int)cudaErrorInvalidValue;
  const int flat = wn == W && W % 2 == 0 && K <= 256 && (K * W) % 4 == 0 &&
                   ((uintptr_t)item & 15) == 0;
  const int codes16 = C % 16 == 0 && ((uintptr_t)codes & 15) == 0 && pitch % 16 == 0;
  cudaError_t err = hdc_set_smem(dense_hdc_kernel<NP, RC>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_frames, (unsigned)((W + wn - 1) / wn));
  if (am.ncls && grid.y > 1) {  // frames split across blocks sum in the scratch rows
    err = cudaMemsetAsync(am.scratch, 0, (size_t)n_frames * (am.ncls + 1) * 4, stream);
    if (err != cudaSuccess) return (int)err;
  }
  dense_hdc_kernel<NP, RC><<<grid, warps * 32, smem, stream>>>(
      (const uint8_t*)codes, (const uint32_t*)item, (const uint32_t*)elec,
      (uint32_t*)out, window, C, K, W, C8, wn, flat, codes16, codes_kmax4(K), fpr, pitch, am);
  return (int)cudaGetLastError();
}

// out: the frame words, or null when only the AM epilogue's results are
// wanted; cls: ncls >= 1 class rows for the epilogue, or null (ncls 0), with
// scratch: (n_frames, ncls + 1) int32 for frames split across tiles.
// Codes: n_frames frames, fpr to a batch row, rows pitch bytes apart.
HDC_EXPORT int dense_hdc_launch(const void* codes, const void* item,
                                const void* elec, void* out, long long n_frames,
                                int window, int C, int K, int W, long long fpr,
                                long long pitch, const void* cls, void* scores, void* preds,
                                void* scratch, int ncls, void* stream) {
  if (n_frames <= 0) return 0;
  if (C <= 0 || C > DENSE_MAX_C || K <= 0 || W <= 0 || window <= 0 || fpr <= 0 || ncls < 0 ||
      (ncls > 0 && (!cls || !scores || !preds || !scratch)) || (!ncls && !out))
    return (int)cudaErrorInvalidValue;
  const DenseAM am = {(const uint32_t*)cls, (int*)scores, (int*)preds, (int*)scratch, ncls};
  cudaStream_t st = (cudaStream_t)stream;
  if (bitslice_planes(C) == 8)
    return dense_launch<8, 8>(codes, item, elec, out, n_frames, window, C, K, W, fpr, pitch,
                              am, st);
  return dense_launch<15, 4>(codes, item, elec, out, n_frames, window, C, K, W, fpr, pitch,
                             am, st);
}
