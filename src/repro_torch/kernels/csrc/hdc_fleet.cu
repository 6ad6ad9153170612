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
// (P, C, K, W) uint32, owner (S,) int32, order (S,) int32 (the sessions
// sorted by owner; the wrapper builds it on the device), codes
// (S, T32, C) uint8, tm (S, K1, T32 / 32) uint32, chan_mask (S, C) uint32
// or null -> out (S, K1, 32 W) int32.
//
// Bound on this card.  The least work is one word operation per (cycle,
// channel, word) -- on bit-sliced counter planes one word operation
// advances the counts of 32 bit positions -- plus three per (slot, cycle,
// word) in the temporal stage: 0.59 G at the main path's shape (1024
// sessions x 256 cycles, C = 64, W = 32), 0.008 ms at 67 T/s, under the
// 0.010 ms that its 33.6 MB of DRAM bytes take (codes, the bank counted
// once, masks, counts).  At paper geometry one patient's bank is
// 64 x 64 x 32 x 4 B = 512 KiB and the 16-patient bank 8 MiB: it stays in
// the 50 MB L2, but gathered one 128 B row per (cycle, channel) the rows
// move 2.1 GB a round from L2.  What bounds this design is the L2 traffic
// of its slabs and the arithmetic of the counters.
//
// Design.
// * Sessions in owner order.  The wrapper sorts the sessions by bank row on
//   the device (`order`); a block takes SB consecutive sorted sessions, so
//   with tens of sessions per patient they share one bank.  The block
//   loops over their 32-cycle groups, so a session's temporal sums stay in
//   one block and need no atomics.
// * Staged slabs.  The block sweeps the channels an octet at a time: the
//   octet's slab of its bank (8 channels x 64 codes x 32 words, 64 KiB,
//   contiguous in the table) comes into shared memory by TMA bulk copies
//   completing on an mbarrier, double-buffered, and is read there by all
//   SB x 32 rows (session, cycle) of the block, so the bank crosses from L2
//   once per 128 rows: 1 GiB at the main shape against 2.1 GB of row
//   gathers.  Each step issues the next step's slab, across sweeps and
//   groups; the next group's codes and slot masks come by cp.async a group
//   ahead and are clamped to K - 1 once, in place.  A block whose sessions
//   have several bank rows sweeps once per distinct row.
// * Bit-sliced counters.  A warp carries RC rows of one session; a
//   half-warp takes every other row and each lane two adjacent words, read
//   with one 64-bit load a (row, channel) (codes broadcast from shared
//   memory).  The words are multiplied by the mask and added to the row's
//   counters (bitslice.cuh: a carry-save tree, 3 operations a word at 8
//   planes) or ORed.  The threshold is per session (renormalised under the
//   mask: ceil(thr * live / C), at least 1; majority is cnt >= live / 2 + 1)
//   and one top-down compare gives the spatial word.
// * Temporal stage: a warp per (session, word) holds 32 cycles' words and
//   transposes them (warp_transpose32: five shuffle stages, the
//   hv.bit_transpose32 LSB-first cycle order); lane b adds its masked
//   popcounts into the session's (K1, D) shared counter bank, laid out as
//   the output so no access conflicts.
// Planes: 8 (RC = 8, four sessions a block) up to C = 255, 15 (RC = 4, two
// sessions) up to C = 32767.  Where shared memory runs out the word tile
// narrows (K up to 256 codes are staged; slabs that are not one contiguous
// range are copied word by word with cp.async) and then SB shrinks; a
// launch fails only where one session's counter bank does not fit.  Codes
// past a session's length are masked off by tm; out-of-alphabet codes
// clamp within their channel; owners out of range clamp to [0, P).
#include "common.cuh"
#include "bitslice.cuh"

// four sessions a block at 8 planes: 1024 sessions make 256 blocks, two
// full waves on 132 SMs (`or`, one word a row, could hold six, but 171
// blocks leave a second wave of 39)
#define FLEET_THREADS 512

struct FleetArgs {
  const uint32_t* tables;
  const int* owner;
  const int* order;
  const uint8_t* codes;
  const uint32_t* tm;
  const uint32_t* chan_mask;
  int* out;
  int S, T32, C, K, W, K1, P, mode, threshold;
  int SB, C8, Wp, Kc, wn, ws, flat, codes16;  // set by the launcher
  uint32_t kmax4;
};

// shared words before the slabs: two slab mbarriers, counters, spatial
// words, two groups' slot masks, sessions, owners, thresholds, distinct
// owners and their count, mask words; a multiple of four, so the slabs are
// 16-byte aligned
__host__ __device__ static inline size_t fleet_head_words(int SB, int K1, int W, int Wp,
                                                          int C8, bool masked) {
  size_t words = 4 + (size_t)SB * K1 * 32 * W + (size_t)SB * 32 * Wp + (size_t)2 * SB * K1 +
                 (size_t)SB * 4 + 1 + (masked ? (size_t)SB * C8 : 0);
  return (words + 3) & ~(size_t)3;
}

__host__ __device__ static inline long long floor_div(long long n, long long d) {
  long long q = n / d;
  return (n % d != 0 && n < 0) ? q - 1 : q;
}

template <bool COUNT, int NP, int RC>
__global__ void __launch_bounds__(FLEET_THREADS, 1) hdc_fleet_kernel(const FleetArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int SB = a.SB, K1 = a.K1, W = a.W, Wp = a.Wp, C = a.C, C8 = a.C8, K = a.K;
  const int Kc = a.Kc, wn = a.wn, ws = a.ws;
  const int D = 32 * W;
  const bool masked = a.chan_mask != nullptr;
  const size_t head = fleet_head_words(SB, K1, W, Wp, C8, masked);
  const size_t slab = slab_words(K, ws);
  uint64_t* bars = (uint64_t*)sm;                    // 2 slab mbarriers
  int* acc = (int*)(sm + 4);                         // SB x K1 x D
  uint32_t* sp = (uint32_t*)acc + SB * K1 * D;       // SB x 32 x Wp spatial words
  uint32_t* tmw = sp + SB * 32 * Wp;                 // 2 x SB x K1 slot masks
  int* sess = (int*)(tmw + 2 * SB * K1);             // SB session indices (-1: none)
  int* own = sess + SB;                              // SB bank rows
  int* thr = own + SB;                               // SB thresholds
  int* uown = thr + SB;                              // distinct bank rows, then their count
  uint32_t* cm = (uint32_t*)(uown + SB + 1);         // SB x C8 mask words
  uint32_t* slabs = sm + head;                       // 2 x slab, double-buffered
  uint8_t* ctile = (uint8_t*)(slabs + 2 * slab);     // 2 x SB x 32 x C8 codes

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int i = tid; i < SB * K1 * D; i += nt) acc[i] = 0;
  for (int i = tid; i < 2 * SB * 8 * C8; i += nt) ((uint32_t*)ctile)[i] = 0u;  // pad bytes stay 0
  if (tid < SB) {
    const long long q = (long long)blockIdx.x * SB + tid;
    int s = -1, o = 0;
    if (q < a.S) {
      s = a.order[q];
      o = a.owner[s];
      o = o < 0 ? 0 : (o >= a.P ? a.P - 1 : o);
    }
    sess[tid] = s;
    own[tid] = o;
  }
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // distinct bank rows, in slot order (sorted sessions: usually one)
    int n = 0;
    for (int b = 0; b < SB; ++b) {
      bool seen = sess[b] < 0;
      for (int u = 0; u < n; ++u) seen |= uown[u] == own[b];
      if (!seen) uown[n++] = own[b];
    }
    uown[SB] = n;
  }
  if (masked) {
    for (int i = tid; i < SB * C8; i += nt) {
      const int b = i / C8, c = i - b * C8, s = sess[b];
      cm[i] = (s >= 0 && c < C) ? a.chan_mask[(long long)s * C + c] : 0u;
    }
  }
  __syncthreads();
  if (COUNT && warp < SB) {
    int live = C;
    if (masked) {
      unsigned v = 0u;
      for (int c = lane; c < C; c += 32) v += cm[warp * C8 + c];
      live = (int)__reduce_add_sync(0xffffffffu, v);
    }
    if (lane == 0) {
      long long t;
      if (a.mode == 1) {
        t = a.threshold;
        if (masked) {
          t = C > 0 ? floor_div((long long)a.threshold * live + C - 1, C) : 0;
          t = t < 1 ? 1 : t;
        }
      } else {
        t = floor_div(live, 2) + 1;  // 2 cnt > live
      }
      t = t > 0x7fffffffLL ? 0x7fffffffLL : t;
      thr[warp] = (int)(t < -0x7fffffffLL ? -0x7fffffffLL : t);
    }
  }
  __syncthreads();

  const int G = a.T32 / 32;
  const int n_own = uown[SB];
  const int nwt = (W + wn - 1) / wn;
  const int nocts = C8 / 8;
  // Warp v carries RC rows of one session; half-warp h (lane = 16 h + p)
  // takes rows j0 + h, j0 + h + 2, ... and words w0 + 2p, w0 + 2p + 1.
  constexpr int RL = RC / 2;        // rows a lane carries
  const int sb = (warp * RC) >> 5;  // the session slot of this warp's rows
  const int j0 = (warp * RC) & 31;  // and their first cycle
  const int h = lane >> 4, pw = 2 * (lane & 15);
  const uint32_t* cmr = cm + sb * C8;
  // group gg's codes and slot masks into buffer gbuf, a group ahead: in
  // 16-byte cp.async pieces where a session's rows allow (clamped in place
  // once they are in: clamp_group), else byte by byte, clamped
  auto stage_group = [&](int gg, int gbuf) {
    uint8_t* ct = ctile + gbuf * SB * 32 * C8;
    for (int b = 0; b < SB; ++b) {
      const int s = sess[b];
      if (s < 0) continue;
      const uint8_t* src = a.codes + ((long long)s * a.T32 + (long long)gg * 32) * C;
      uint8_t* dst = ct + b * 32 * C8;
      if (a.codes16) {
        for (int i = tid; i < 2 * C; i += nt) cp_async16(dst + 16 * i, src + 16 * i);
      } else {
        for (int i = tid; i < 32 * C; i += nt) {
          const int j = i / C, c = i - j * C;
          const int v = src[i];
          dst[j * C8 + c] = (uint8_t)(v < K ? v : K - 1);
        }
      }
    }
    for (int i = tid; i < SB * K1; i += nt) {
      const int b = i / K1, k = i - b * K1, s = sess[b];
      if (s >= 0) cp_async4(tmw + gbuf * SB * K1 + i, a.tm + ((long long)s * K1 + k) * G + gg);
    }
  };
  auto clamp_group = [&](int gbuf) {
    if (!a.codes16 || a.kmax4 == 0xffffffffu) return;
    uint32_t* ct = (uint32_t*)(ctile + gbuf * SB * 32 * C8);
    for (int i = tid; i < SB * 8 * C8; i += nt) ct[i] = __vminu4(ct[i], a.kmax4);
  };
  // the slab of octet oc of sweep (word tile wt, distinct bank row u) into
  // slab buffer sbuf
  auto stage_step = [&](int wt, int u, int oc, int sbuf) {
    stage_slab(slabs + sbuf * slab, a.tables + (long long)uown[u] * C * K * W, 8 * oc, C,
               K, W, Kc, wt * wn, wn, ws, a.flat, bars + sbuf);
  };
  // The steps (group, word tile, bank row, octet) form one pipeline: each
  // step issues the next step's slab, across sweeps and groups, so the
  // first slab of a group is in flight during the previous temporal stage.
  int bf = 0;        // the slab buffer of the current step
  unsigned ph = 0u;  // bit b: the parity of slab buffer b's next completion
  if (G > 0) {
    stage_group(0, 0);
    if (nocts > 0) stage_step(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  clamp_group(0);
  for (int g = 0; g < G; ++g) {
    const int gb = g & 1;
    const uint8_t* crow = ctile + (gb * SB * 32 + sb * 32 + j0 + h) * C8;
    const uint32_t* tmg = tmw + gb * SB * K1;
    bool next_group_staged = g + 1 >= G;  // issued with the group's first step

    for (int wt = 0; wt < nwt; ++wt) {
      const int w0 = wt * wn, wcount = min(wn, W - w0);
      const bool wa = pw < wcount, wb = pw + 1 < wcount;
      for (int u = 0; u < n_own; ++u) {
        // this warp's rows are computed in the sweep of their bank row
        const bool mine = sess[sb] >= 0 && own[sb] == uown[u];  // uniform over the warp
        const int t_s = COUNT ? thr[sb] : 0;
        BitCounter<NP> cnt[RL][2];
        uint32_t orw[RL][2];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (COUNT) cnt[i][e].clear();
            orw[i][e] = 0u;
          }
        }
        for (int oc = 0; oc < nocts; ++oc) {
          int nwt_ = wt, nu = u, noc = oc + 1;
          bool more = true;
          if (noc == nocts) {
            noc = 0;
            if (++nu == n_own) {
              nu = 0;
              if (++nwt_ == nwt) {
                nwt_ = 0;
                more = g + 1 < G;
              }
            }
          }
          if (!next_group_staged) {
            stage_group(g + 1, gb ^ 1);
            next_group_staged = true;
          }
          if (more) stage_step(nwt_, nu, noc, bf ^ 1);
          cp_async_commit();
          cp_async_wait<1>();
          if (a.flat) {
            mbar_wait(bars + bf, (ph >> bf) & 1u);
            ph ^= 1u << bf;
          }
          __syncthreads();  // the slab of this step (and the group's codes) are in
          if (mine && wa) {
            const uint32_t* sl = slabs + bf * slab + pw;
            const int c8 = 8 * oc;
            uint32_t mk[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) mk[q] = masked ? cmr[c8 + q] : 1u;
#pragma unroll
            for (int i = 0; i < RL; ++i) {
              const uint2 cc = *(const uint2*)(crow + 2 * i * C8 + c8);
              uint32_t x0[8], x1[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const uint32_t code = ((q < 4 ? cc.x : cc.y) >> (8 * (q & 3))) & 0xffu;
                uint2 v = make_uint2(0u, 0u);
                if (c8 + q < C) v = *(const uint2*)(sl + (q * Kc + code) * ws);
                x0[q] = masked ? v.x * mk[q] : v.x;
                x1[q] = masked ? v.y * mk[q] : v.y;
              }
              if (COUNT) {
                cnt[i][0].add8(x0);
                cnt[i][1].add8(x1);
              } else {
                orw[i][0] |= (x0[0] | x0[1]) | (x0[2] | x0[3]) | (x0[4] | x0[5]) | (x0[6] | x0[7]);
                orw[i][1] |= (x1[0] | x1[1]) | (x1[2] | x1[3]) | (x1[4] | x1[5]) | (x1[6] | x1[7]);
              }
            }
          }
          __syncthreads();  // every warp is done with the slab before it is refilled
          bf ^= 1;
        }
        if (mine) {
#pragma unroll
          for (int i = 0; i < RL; ++i) {
            uint32_t* row = sp + (sb * 32 + j0 + 2 * i + h) * Wp + w0 + pw;
            if (wa) row[0] = COUNT ? cnt[i][0].at_least(t_s) : orw[i][0];
            if (wb) row[1] = COUNT ? cnt[i][1].at_least(t_s) : orw[i][1];
          }
        }
      }
    }
    if (!next_group_staged) stage_group(g + 1, gb ^ 1);  // no step issued it (C = 0)
    cp_async_commit();
    cp_async_wait<0>();  // the next group's codes and slot masks
    __syncthreads();
    if (g + 1 < G) clamp_group(gb ^ 1);  // read after the barrier below

    for (int task = warp; task < SB * W; task += nwarps) {
      const int b = task / W, w = task - b * W;
      if (sess[b] < 0) continue;  // uniform over the warp
      const uint32_t mine = warp_transpose32(sp[(b * 32 + lane) * Wp + w], lane);
      int* ab = acc + b * K1 * D + w * 32 + lane;
      for (int k = 0; k < K1; ++k) ab[k * D] += __popc(mine & tmg[b * K1 + k]);
    }
    __syncthreads();
  }

  for (int b = 0; b < SB; ++b) {
    const int s = sess[b];
    if (s < 0) continue;
    int* os = a.out + (long long)s * K1 * D;
    const int* ab = acc + b * K1 * D;
    for (int i = tid; i < K1 * D; i += nt) os[i] = ab[i];
  }
}

template <bool COUNT, int NP, int RC>
static int fleet_launch(FleetArgs a, bool masked, cudaStream_t stream) {
  const int wps = 32 / RC;  // warps a session takes
  const int sb_max = a.S < FLEET_THREADS / 32 / wps ? a.S : FLEET_THREADS / 32 / wps;
  // the widest word tile, then the most sessions, that fit in shared memory
  size_t smem = 0;
  int sb = 0, wn = a.W < 32 ? a.W : 32;
  for (; wn >= 1 && !sb; wn = wn > 1 ? (wn + 1) / 2 : 0) {
    for (int b = sb_max; b >= 1; --b) {
      smem = (fleet_head_words(b, a.K1, a.W, a.Wp, a.C8, masked) +
              2 * slab_words(a.K, wn + (wn & 1))) * 4 +
             (size_t)2 * b * 32 * a.C8;
      if (smem <= HDC_MAX_SMEM) {
        sb = b;
        break;
      }
    }
    if (sb) break;
  }
  if (!sb) return (int)cudaErrorInvalidValue;  // one session's counters do not fit
  a.SB = sb;
  a.wn = wn;
  a.ws = wn + (wn & 1);
  a.Kc = a.K < 256 ? a.K : 256;
  a.flat = a.wn == a.W && a.ws == a.W && a.Kc == a.K && (a.K * a.W) % 4 == 0 &&
           ((uintptr_t)a.tables & 15) == 0;
  a.codes16 = a.C % 16 == 0 && ((uintptr_t)a.codes & 15) == 0;
  a.kmax4 = codes_kmax4(a.K);
  cudaError_t err = hdc_set_smem(hdc_fleet_kernel<COUNT, NP, RC>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.S + sb - 1) / sb);
  hdc_fleet_kernel<COUNT, NP, RC><<<blocks, sb * wps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

HDC_EXPORT int hdc_fleet_launch(const void* tables, const void* owner, const void* order,
                                const void* codes, const void* tm, const void* chan_mask,
                                void* out, int S, int T32, int C, int K, int W, int K1,
                                int P, int mode, int threshold, void* stream) {
  if (S <= 0) return 0;
  if (C < 0 || C > BITSLICE_MAX_COUNT || K <= 0 || W <= 0 || K1 <= 0 || P <= 0 ||
      T32 < 0 || T32 % 32 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  FleetArgs a = {(const uint32_t*)tables, (const int*)owner, (const int*)order,
                 (const uint8_t*)codes, (const uint32_t*)tm, (const uint32_t*)chan_mask,
                 (int*)out, S, T32, C, K, W, K1, P, mode, threshold,
                 0, (C + 7) & ~7, W | 1, 0, 0, 0, 0, 0, 0u};
  const bool masked = chan_mask != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return fleet_launch<false, 8, 8>(a, masked, st);
  if (bitslice_planes(C) == 8) return fleet_launch<true, 8, 8>(a, masked, st);
  return fleet_launch<true, 15, 4>(a, masked, st);
}
