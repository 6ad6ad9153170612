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
//
// Counts epilogue (replaces calibration's plain datapath,
// core/classifier.py::frame_counts: the (N, window, C, S) position gather,
// the (N, window, C, W) int32 one-hot words, the OR over channels and the
// unpacked sum over the window): the warp that would compare word k of a
// frame writes the frame's 32 counts of bits 32 k .. 32 k + 31 instead, one
// coalesced 128-byte store, into (n_frames, D) int32; no frame words, no AM.
// A compile-time mode (CNT), so the encoder's and the AM epilogue's
// instantiations keep their code; its own are built in
// hdc_encoder_counts.cu (the templates are in hdc_encoder.cuh).  Bound,
// for an hour (7199 frames of 256 cycles x 64 channels, D = 1024): its
// operations are the encoder's, 1.0 G binds and word operations, 0.060 ms
// at the 32-bit integer rate (16.75 T/s), above its bytes (the codes once
// and the counts written once, 118 MB + 29.5 MB: 0.044 ms at 3.35 TB/s).
#include "hdc_encoder.cuh"

// out: the frame words, or null when only the AM epilogue's results are
// wanted; cls: ncls >= 1 class rows for the epilogue, or null (ncls 0);
// counts: the (n_frames, D) temporal counts (the counts epilogue: then no
// frame words and no classes), or null.
// Codes: n_frames frames, fpr to a batch row, rows pitch bytes apart.
HDC_EXPORT int hdc_encoder_launch(const void* codes, const void* item, const void* elec,
                                  void* out, long long n_frames, int window, int C, int K,
                                  int S, int L, int temporal_threshold, int thinning,
                                  int spatial_threshold, long long fpr, long long pitch,
                                  const void* cls, void* scores, void* preds, int ncls,
                                  void* counts, void* stream) {
  if (n_frames <= 0) return 0;
  if (window <= 0 || C <= 0 || K <= 0 || S <= 0 || L <= 0 || L > 256 || (S * L) % 32 ||
      fpr <= 0 || ncls < 0 || (ncls > 0 && (!cls || !scores || !preds)) ||
      (counts ? out || ncls : !ncls && !out))
    return (int)cudaErrorInvalidValue;
  EncArgs a;
  a.codes = (const uint8_t*)codes;
  a.item = (const uint8_t*)item;
  a.elec = (const uint8_t*)elec;
  a.out = (uint32_t*)out;
  a.counts = (int*)counts;
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
  size_t tab = (size_t)C * (K < 256 ? K : 256) * S;
  if (enc_smem(1, 1, S * L, a.np, ncls, tab) > HDC_MAX_SMEM) tab = 0;
  return counts ? enc_counts_launch(a, tab, st) : enc_paths<false>(a, tab, st);
}
