// Fused sparse-HDC frame encoder (CompIM position domain), with the
// item-memory gather inside.
//
// Replaces the TPU kernel src/repro/kernels/hdc_encoder/kernel.py::encoder_pallas
// (body _encoder_kernel) together with the gather its wrapper runs just
// before it (hdc_encoder/ops.py: im_lookup_positions).  Per frame n:
//   per cycle t, channel c and segment s: the bound position
//     p = (item[c, min(codes[n, t, c], K - 1), s] + elec[c, s]) mod L;
//   spatial bit s * L + p: the OR over the channels (with spatial thinning,
//     [number of channels at that position >= spatial_threshold]);
//   over the window: count each of the D = S * L bits, keep count >=
//   temporal_threshold, pack LSB-first (d = 32 w + b) into D / 32 words.
// Every cycle of the window counts (the TPU body's 32-cycle chunk loop
// drops window % 32 cycles; the function computed here is the reference's
// encoder_ref).  Shapes: codes (N, window, C) uint8, item (C, K, S) uint8,
// elec (C, S) uint8 -> out (N, D / 32) uint32.
//
// Bound on this card: bytes.  The least traffic is the codes, the table and
// the frames once each: 7.91 MB at the main path's shape (477 frames x 256
// cycles x 64 channels, a 32 KB table, 61 KB of frames), 0.0024 ms at
// 3.35 TB/s.  The least work, one bind per (frame, cycle, channel, segment)
// and one word operation per (frame, cycle, word), is 66 M operations
// (0.0010 ms at 67 T/s).  The (N, window, C, S) position tensor of the
// first design (62.6 MB written by a gather, then read back) never exists.
// What bounds this design is instruction issue: a few integer instructions
// and one shared-memory atomic per (cycle, channel, segment).
//
// Design.
// * The bound table in shared memory.  A block builds (item + elec) mod L,
//   C x min(K, 256) x S bytes (32 KB at paper geometry), once, and then
//   walks frames (a persistent grid: as many blocks as fit on the card), so
//   the table is staged once per block, not once per frame.  Codes are
//   clamped to K - 1 four at a time (__vminu4).
// * A lane per cycle.  A warp takes one (frame, 32-cycle group); lane t
//   owns cycle 32 g + t.  It reads its cycle's codes 16 at a time (one
//   16-byte load), the 8 segments' positions of a channel with one 8-byte
//   table load (paper path; one byte a segment otherwise), and sets bit
//   s * L + p of its cycle's spatial row with a shared-memory atomicOr,
//   which returns nothing to wait for.  The rows are laid out lane by lane
//   (word k of lane t at 32 k + t), so every lane stays in its own bank
//   whatever word it hits, and segments need no word alignment.  A bit kept
//   in registers needs a select per word of its segment instead (15
//   instructions a position); the atomic needs none.
// * Thinning: the row is the top plane of a saturating bit-sliced counter
//   of NP planes (the top plane sticky, 2^(NP-1) >= spatial_threshold), in
//   the same layout: a position's one-hot ripples up the lower planes by
//   load, XOR and store (each lane owns its words) until its carry is
//   spent, and what is left is ORed into the top plane; count >= thr is the
//   top plane or a top-down compare of the lower planes.  At threshold 2
//   (the sparse_naive path) that is two loads and two stores, no branch
//   and no compare.
// * Temporal counts.  Per word the warp transposes its 32 cycles' words
//   (warp_transpose32: five shuffle stages) and lane b adds __popc of its
//   word to the frame's count of bit 32 w + b in shared memory: the groups
//   of a frame run on different warps and meet there (shared atomics).
//   Cycles past the window leave zero rows.  After one barrier a warp per
//   word compares the counts and packs them with __ballot_sync.  The counts
//   are double-buffered, so one barrier per batch of frames suffices.
// A block has up to 8 warps and takes max(1, warps / G) frames at a time (G
// 32-cycle groups a frame); where shared memory runs out it takes fewer
// warps.  Paths: SG = 8 segments a table load (S % 8 == 0), else 1; one
// plane, two, or a plane count read at run time.
// Thinning thresholds <= 0 set every bit, those above C none.  Where the
// table does not fit in shared memory, positions are bound from the
// device's item and electrode tables.
//
// Codes may be a strided batch: frames [r * fpr, (r + 1) * fpr) lie
// contiguously from byte r * pitch (frame_view of a (B, T, C) stream, whose
// rows are T * C bytes apart however many whole frames they hold), so the
// view is read where it lies and never copied.
//
// AM epilogue (replaces src/repro/kernels/hdc_am/kernel.py::am_search_pallas
// and the argmax on the offline path): given (ncls, W) class rows, the warp
// that packs word k of a frame also adds that word's overlap with each class
// (am.cuh) into the frame's scores in shared memory; after one more barrier
// a warp per frame writes its ncls scores and its prediction (argmax, ties
// to the lower class).  The frame words are then written only if asked for.
#include "common.cuh"
#include "am.cuh"

#define ENC_WARPS 8

struct EncArgs {
  const uint8_t* codes;
  const uint8_t* item;
  const uint8_t* elec;
  uint32_t* out;        // (n_frames, W) frame words, or null (scores only)
  const uint32_t* cls;  // (ncls, W) class rows, or null: no AM epilogue
  int* scores;          // (n_frames, ncls) int32
  int* preds;           // (n_frames,) int32
  long long n_frames;
  long long fpr;        // frames a batch row holds
  long long pitch;      // bytes between batch rows of codes
  int ncls;
  int window, C, K, S, L;
  int tthr;     // temporal threshold
  int sthr;     // spatial threshold (thinning), 1 for the OR mode
  int np;       // counter planes: 1 for the OR mode
  int spat;     // -1: encode; 0: every spatial bit off; 1: every bit on
  int fb;       // frames a block takes at a time
  int codes16;  // codes rows are 16-byte loadable (C % 16 == 0, aligned)
  uint32_t kmax4;
};

// shared bytes: two count buffers of fb frames, each warp's np planes of 32
// rows, fb frames' AM scores (ncls each, rounded to 16 bytes), the table
__host__ __device__ static inline size_t enc_score_words(int fb, int ncls) {
  return ((size_t)fb * ncls + 3) & ~(size_t)3;
}
__host__ __device__ static inline size_t enc_smem(int warps, int fb, int D, int np, int ncls,
                                                  size_t tab) {
  return (size_t)2 * fb * D * 4 + (size_t)warps * np * D * 4 + enc_score_words(fb, ncls) * 4 +
         ((tab + 15) & ~(size_t)15);
}

// the codes of frame n: row n / fpr of the batch, frame n % fpr within it
__device__ __forceinline__ const uint8_t* frame_codes(const EncArgs& a, long long n) {
  const long long r = n / a.fpr;
  return a.codes + r * a.pitch + (n - r * a.fpr) * a.window * a.C;
}

// 16 codes of one cycle from channel c0, clamped to K - 1
__device__ __forceinline__ void load_codes16(const EncArgs& a, const uint8_t* crow, int c0,
                                             uint32_t (&cw)[4]) {
  if (a.codes16) {
    const uint4 v = __ldg((const uint4*)(crow + c0));
    cw[0] = v.x;
    cw[1] = v.y;
    cw[2] = v.z;
    cw[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) cw[q] = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (c0 + i < a.C) cw[i >> 2] |= (uint32_t)__ldg(crow + c0 + i) << (8 * (i & 3));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) cw[q] = __vminu4(cw[q], a.kmax4);
}

__device__ __forceinline__ int bind_mod(int v, int L) {
  return v < L ? v : (v - L < L ? v - L : v % L);
}

// the bound positions of segments s0 .. s0 + SG - 1 for (c, code)
template <int SG, bool GT>
__device__ __forceinline__ void fetch(const EncArgs& a, const uint8_t* tab, int Kc, int c,
                                      uint32_t code, int s0, uint32_t (&pos)[SG]) {
  if constexpr (GT) {
#pragma unroll
    for (int g = 0; g < SG; ++g) {
      const int s = s0 + g;
      pos[g] = (uint32_t)bind_mod((int)__ldg(a.item + ((long long)c * a.K + code) * a.S + s) +
                                      (int)__ldg(a.elec + (long long)c * a.S + s),
                                  a.L);
    }
  } else if constexpr (SG == 8) {
    const uint2 e = *(const uint2*)(tab + (size_t)(c * Kc + (int)code) * a.S + s0);
#pragma unroll
    for (int g = 0; g < 8; ++g) pos[g] = ((g < 4 ? e.x : e.y) >> (8 * (g & 3))) & 0xffu;
  } else {
#pragma unroll
    for (int g = 0; g < SG; ++g) pos[g] = tab[(size_t)(c * Kc + (int)code) * a.S + s0 + g];
  }
}

// The bound table (item + elec) mod L, C x Kc x S bytes, built by the block.
__device__ __forceinline__ void build_table(const EncArgs& a, uint8_t* tab, int Kc) {
  for (int r = threadIdx.x; r < a.C * Kc; r += blockDim.x) {  // row (c, k)
    const int c = r / Kc, k = r - c * Kc;
    const uint8_t* src = a.item + ((long long)c * a.K + k) * a.S;
    const uint8_t* e = a.elec + (long long)c * a.S;
    for (int s = 0; s < a.S; ++s)
      tab[(size_t)r * a.S + s] = (uint8_t)bind_mod((int)__ldg(src + s) + (int)__ldg(e + s), a.L);
  }
}

// One cycle's spatial bits into the lane's planes (zero on entry): plane i,
// word k at pl[(i * W + k) * 32]; the top plane np - 1 becomes the row.
template <int SG, bool GT, int NPT>
__device__ __forceinline__ void encode_cycle(const EncArgs& a, const uint8_t* tab, int Kc,
                                             const uint8_t* crow, uint32_t* pl, int W) {
  uint32_t* top = pl + (a.np - 1) * W * 32;
  for (int s0 = 0; s0 < a.S; s0 += SG) {
    int off[SG];
#pragma unroll
    for (int g = 0; g < SG; ++g) off[g] = (s0 + g) * a.L;
    for (int c0 = 0; c0 < a.C; c0 += 16) {
      uint32_t cw[4];
      load_codes16(a, crow, c0, cw);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (c0 + i < a.C) {  // uniform over the warp
          const uint32_t code = (cw[i >> 2] >> (8 * (i & 3))) & 0xffu;
          uint32_t pos[SG];
          fetch<SG, GT>(a, tab, Kc, c0 + i, code, s0, pos);
#pragma unroll
          for (int g = 0; g < SG; ++g) {
            const uint32_t bit = (uint32_t)off[g] + pos[g];
            const int k = (int)(bit >> 5);
            uint32_t x = 1u << (bit & 31u);
            if constexpr (NPT == 1) {
              atomicOr(top + k * 32, x);
            } else if constexpr (NPT == 2) {  // plane 0, then the carry into the top
              const uint32_t q = pl[k * 32];
              pl[k * 32] = q ^ x;
              top[k * 32] |= q & x;
            } else {  // up the lower planes while it carries
              for (int p = 0; p < a.np - 1 && x; ++p) {
                uint32_t* w = pl + (p * W + k) * 32;
                const uint32_t q = *w;
                *w = q ^ x;
                x &= q;
              }
              if (x) top[k * 32] |= x;
            }
          }
        }
      }
    }
  }
  // count >= thr: the sticky top plane, or the lower planes' count, compared
  // from the top down (thr < 2^(np-1); at thr == 2^(np-1) the top alone)
  if (NPT != 1 && (a.sthr >> (a.np - 1)) == 0) {
    for (int k = 0; k < W; ++k) {
      uint32_t gt = 0u, eq = 0xffffffffu;
      for (int p = a.np - 2; p >= 0; --p) {
        const uint32_t v = pl[(p * W + k) * 32];
        const uint32_t t = 0u - (uint32_t)((a.sthr >> p) & 1);  // all ones where thr has bit p
        gt |= eq & v & ~t;
        eq &= ~(v ^ t);
      }
      top[k * 32] |= gt | eq;
    }
  }
}

template <int SG, bool GT, int NPT>
__global__ void __launch_bounds__(ENC_WARPS * 32) hdc_encoder_kernel(const EncArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int D = a.S * a.L, W = D >> 5;
  const int G = (a.window + 31) >> 5, fb = a.fb;
  const int Kc = a.K < 256 ? a.K : 256;
  int* counts = (int*)smem;                                 // 2 x fb x D
  uint32_t* planes = (uint32_t*)(counts + 2 * fb * D);      // warps x np x W x 32
  int* sc = (int*)(planes + nwarps * a.np * D);             // fb x ncls AM sums
  uint8_t* tab = (uint8_t*)(sc + enc_score_words(fb, a.ncls));  // C x Kc x S

  for (int i = tid; i < 2 * fb * D; i += nt) counts[i] = 0;
  for (int i = tid; i < fb * a.ncls; i += nt) sc[i] = 0;
  if constexpr (!GT) build_table(a, tab, Kc);
  __syncthreads();

  uint32_t* pl = planes + warp * a.np * D + lane;  // the lane's column
  uint32_t* row = pl + (a.np - 1) * D;             // its top plane
  int buf = 0;
  for (long long f0 = (long long)blockIdx.x * fb; f0 < a.n_frames;
       f0 += (long long)gridDim.x * fb, buf ^= 1) {
    int* cnt = counts + buf * fb * D;
    for (int task = warp; task < fb * G; task += nwarps) {
      const int fi = task / G, g = task - fi * G;
      const long long n = f0 + fi;
      if (n >= a.n_frames) break;  // uniform over the warp; later tasks are later frames
      const int t = 32 * g + lane;
      for (int k = 0; k < a.np * W; ++k) pl[k * 32] = 0u;
      if (t < a.window) {
        if (a.spat > 0) {
          for (int k = 0; k < W; ++k) row[k * 32] = 0xffffffffu;
        } else if (a.spat < 0) {
          encode_cycle<SG, GT, NPT>(a, tab, Kc, frame_codes(a, n) + (long long)t * a.C, pl, W);
        }
      }
      __syncwarp();
      for (int k = 0; k < W; ++k) {
        const int pc = __popc(warp_transpose32(row[k * 32], lane));
        if (pc) atomicAdd(&cnt[fi * D + 32 * k + lane], pc);
      }
    }
    __syncthreads();  // every group of the batch is counted
    for (int idx = warp; idx < fb * W; idx += nwarps) {
      const int fi = idx / W, k = idx - fi * W;
      int* cp = cnt + fi * D + 32 * k + lane;
      const int v = *cp;
      *cp = 0;  // ready for the batch after next; the next batch counts in the other buffer
      const unsigned word = __ballot_sync(0xffffffffu, v >= a.tthr);
      const long long n = f0 + fi;
      if (n < a.n_frames) {
        if (lane == 0 && a.out) a.out[n * W + k] = word;
        for (int c = lane; c < a.ncls; c += 32)
          atomicAdd(&sc[fi * a.ncls + c],
                    am_word(word, __ldg(a.cls + (long long)c * W + k), AM_OVERLAP));
      }
    }
    if (a.ncls) {
      __syncthreads();  // every word of the batch is scored
      for (int fi = warp; fi < fb; fi += nwarps) {
        const long long n = f0 + fi;
        if (n >= a.n_frames) break;  // uniform over the warp
        int* s = sc + fi * a.ncls;
        am_emit(s, a.ncls, AM_OVERLAP, D, a.scores + n * a.ncls, a.preds + n, lane);
        for (int c = lane; c < a.ncls; c += 32) s[c] = 0;  // each lane its own classes
      }
    }
  }
}

template <int SG, bool GT, int NPT>
static int enc_launch(EncArgs a, size_t tab, cudaStream_t stream) {
  const int D = a.S * a.L, G = (a.window + 31) / 32;
  int warps = 0;
  size_t smem = 0;
  for (int v = ENC_WARPS; v >= 1; v /= 2) {
    const int fb = v / G > 1 ? v / G : 1;
    smem = enc_smem(v, fb, D, a.np, a.ncls, tab);
    if (smem <= HDC_MAX_SMEM) {
      warps = v;
      a.fb = fb;
      break;
    }
  }
  if (!warps) return (int)cudaErrorInvalidValue;
  auto kernel = hdc_encoder_kernel<SG, GT, NPT>;
  cudaError_t err = hdc_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem)) !=
      cudaSuccess)
    return (int)err;
  const long long batches = (a.n_frames + a.fb - 1) / a.fb;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(batches < most ? batches : most);
  kernel<<<grid, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// NPT: the planes fixed at compile time (1 or 2), or 0 for np read at run time
template <int SG, bool GT>
static int enc_dispatch(const EncArgs& a, size_t tab, cudaStream_t stream) {
  if (a.np == 1) return enc_launch<SG, GT, 1>(a, tab, stream);
  if (a.np == 2) return enc_launch<SG, GT, 2>(a, tab, stream);
  return enc_launch<SG, GT, 0>(a, tab, stream);
}

// out: the frame words, or null when only the AM epilogue's results are
// wanted; cls: ncls >= 1 class rows for the epilogue, or null (ncls 0).
// Codes: n_frames frames, fpr to a batch row, rows pitch bytes apart.
HDC_EXPORT int hdc_encoder_launch(const void* codes, const void* item, const void* elec,
                                  void* out, long long n_frames, int window, int C, int K,
                                  int S, int L, int temporal_threshold, int thinning,
                                  int spatial_threshold, long long fpr, long long pitch,
                                  const void* cls, void* scores, void* preds, int ncls,
                                  void* stream) {
  if (n_frames <= 0) return 0;
  if (window <= 0 || C <= 0 || K <= 0 || S <= 0 || L <= 0 || L > 256 || (S * L) % 32 ||
      fpr <= 0 || ncls < 0 || (ncls > 0 && (!cls || !scores || !preds)) || (!ncls && !out))
    return (int)cudaErrorInvalidValue;
  EncArgs a;
  a.codes = (const uint8_t*)codes;
  a.item = (const uint8_t*)item;
  a.elec = (const uint8_t*)elec;
  a.out = (uint32_t*)out;
  a.cls = (const uint32_t*)cls;
  a.scores = (int*)scores;
  a.preds = (int*)preds;
  a.ncls = ncls;
  a.fpr = fpr;
  a.pitch = pitch;
  a.n_frames = n_frames;
  a.window = window;
  a.C = C;
  a.K = K;
  a.S = S;
  a.L = L;
  a.tthr = temporal_threshold;
  a.sthr = 1;
  a.np = 1;
  a.spat = -1;
  a.fb = 1;
  a.codes16 = C % 16 == 0 && ((uintptr_t)codes & 15) == 0 && pitch % 16 == 0;
  a.kmax4 = codes_kmax4(K);
  if (thinning) {
    if (spatial_threshold <= 0) {
      a.spat = 1;
    } else if (spatial_threshold > C) {
      a.spat = 0;
    } else {
      // the fewest planes whose sticky top stands for "at least thr"
      a.sthr = spatial_threshold;
      while ((1 << (a.np - 1)) < spatial_threshold) ++a.np;
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t tab = (size_t)C * (K < 256 ? K : 256) * S;
  if (enc_smem(1, 1, S * L, a.np, ncls, tab) > HDC_MAX_SMEM)
    return enc_dispatch<1, true>(a, 0, st);
  if (S % 8 == 0) return enc_dispatch<8, false>(a, tab, st);
  return enc_dispatch<1, false>(a, tab, st);
}
