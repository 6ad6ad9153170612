// The sparse frame encoder's device code and launch templates
// (hdc_encoder.cu describes the design).  Two objects instantiate them:
// hdc_encoder.cu the frame-word and AM epilogues, hdc_encoder_counts.cu the
// counts epilogue, so that nvcc builds the two halves in parallel.
#pragma once

#include "common.cuh"
#include "am.cuh"

#define ENC_WARPS 8

struct EncArgs {
  const uint8_t* codes;
  const uint8_t* item;
  const uint8_t* elec;
  uint32_t* out;        // (n_frames, W) frame words, or null (scores or counts only)
  int* counts;          // (n_frames, D) int32 temporal counts (CNT), else null
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

// CNT: the counts epilogue in place of the threshold, the pack and the AM
template <int SG, bool GT, int NPT, bool CNT>
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
      const long long n = f0 + fi;
      if constexpr (CNT) {
        if (n < a.n_frames) a.counts[n * D + 32 * k + lane] = v;
      } else {
        const unsigned word = __ballot_sync(0xffffffffu, v >= a.tthr);
        if (n < a.n_frames) {
          if (lane == 0 && a.out) a.out[n * W + k] = word;
          for (int c = lane; c < a.ncls; c += 32)
            atomicAdd(&sc[fi * a.ncls + c],
                      am_word(word, __ldg(a.cls + (long long)c * W + k), AM_OVERLAP));
        }
      }
    }
    if (!CNT && a.ncls) {
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

template <int SG, bool GT, int NPT, bool CNT>
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
  auto kernel = hdc_encoder_kernel<SG, GT, NPT, CNT>;
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
template <int SG, bool GT, bool CNT>
static int enc_planes(const EncArgs& a, size_t tab, cudaStream_t stream) {
  if (a.np == 1) return enc_launch<SG, GT, 1, CNT>(a, tab, stream);
  if (a.np == 2) return enc_launch<SG, GT, 2, CNT>(a, tab, stream);
  return enc_launch<SG, GT, 0, CNT>(a, tab, stream);
}

// The paths: 8 segments a table load (S % 8 == 0) or one; with tab 0 the
// table does not fit in shared memory and positions are bound from device
// memory.
template <bool CNT>
static int enc_paths(const EncArgs& a, size_t tab, cudaStream_t stream) {
  if (!tab) return enc_planes<1, true, CNT>(a, 0, stream);
  if (a.S % 8 == 0) return enc_planes<8, false, CNT>(a, tab, stream);
  return enc_planes<1, false, CNT>(a, tab, stream);
}

// enc_paths<true>, built in hdc_encoder_counts.cu
int enc_counts_launch(const EncArgs& a, size_t tab, cudaStream_t stream);
