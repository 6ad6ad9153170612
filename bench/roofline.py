"""The benchmark's frozen work counts and the card's peaks.

Copied here so that a change to the port cannot move the yardstick.  Every
count follows the algorithm, not an implementation: each input byte read
once, each output byte written once, operations counted from shapes.  A
fusion or a cache in the program changes none of them.

Peaks: NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit.  HBM
bandwidth and the float32 rate are NVIDIA's data sheet, copied from
``src/repro_torch/runtime/roofline.py:42-43``; that file labels the float32
rate as the rate of 32-bit operations, which it is only for floating point.
The integer and logic rate follows from it and from the CUDA C++
Programming Guide's table "Throughput of Native Arithmetic Instructions"
(operations per clock cycle per multiprocessor), compute capability 9.0:
128 float32 fused multiply-adds (counted as 2 operations in the data
sheet's 67 TFLOP/s) against 64 32-bit integer adds, compares, shifts and
bitwise AND/OR/XOR.  That is a quarter of 67 T/s: 16.75 T/s, 132
multiprocessors x 64 x the 1.98 GHz boost clock.  The same table gives
population count 16 per clock; a popcount is counted here at the 64-per-
clock rate, so a bound that holds popcounts is, if anything, too low.  The
host link: PCIe 5.0 x16, the data sheet's 128 GB/s both ways, 64 GB/s in
one direction.  A card set below 700 W runs slower under load; every share
is reported with the power limit ``nvidia-smi`` reads beside it.
"""

from __future__ import annotations

HBM_BW = 3.35e12            # bytes/s, HBM3                  (runtime/roofline.py:42)
PEAK_FP32_FLOPS = 67e12     # float32, an FMA counted as 2   (runtime/roofline.py:43)
PEAK_INT_OPS = PEAK_FP32_FLOPS * 64 / (128 * 2)   # 32-bit integer and logic ops/s
H2D_BW = 64e9               # bytes/s host to card, PCIe 5.0 x16, one direction

# device-trace kernel names (the ``__global__`` functions of
# src/repro_torch/kernels/csrc/*.cu) by the kernel's short name
KERNEL_NAMES = {
    "lbp": "lbp_kernel",
    "hdc_encoder": "hdc_encoder_kernel",
    "dense_hdc": "dense_hdc_kernel",
    "hdc_am": "hdc_am_kernel",
}
# the trace's name for a copy from pinned host memory to the card
H2D_NAME = "HtoD"


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the 32-bit integer and logic rate, the larger."""
    return max(n_bytes / HBM_BW, n_ops / PEAK_INT_OPS)


def lbp_work(rows: int, t: int, channels: int, bits: int) -> tuple[int, int]:
    """One LBP launch over (rows, t, channels) float32 samples: the signal
    read, the (rows, t - bits, channels) uint8 codes written; a compare and
    an insert per code bit.  Copied from ``chip_smoke.py:547-548``."""
    t_out = t - bits
    return rows * t * channels * 4 + rows * t_out * channels, rows * t_out * channels * bits * 2


def encoder_work(n_frames: int, window: int, channels: int, codes_k: int,
                 segments: int, seg_len: int, n_classes: int = 0) -> tuple[int, int]:
    """One sparse encoder launch (CompIM gather, bind, OR bundle, temporal
    count and threshold; with ``n_classes`` its AM epilogue).  Copied from
    ``src/repro_torch/kernels/hdc_encoder/ops.py:26-45`` (``work``)."""
    words = segments * seg_len // 32
    n_bytes = (n_frames * window * channels + channels * codes_k * segments
               + channels * segments)
    n_ops = n_frames * window * channels * segments + n_frames * window * words
    if n_classes:
        n_bytes += n_classes * words * 4 + n_frames * (n_classes + 1) * 4
        n_ops += n_frames * n_classes * words * 2
    else:
        n_bytes += n_frames * words * 4
    return n_bytes, n_ops


def dense_work(n_frames: int, window: int, channels: int, codes_k: int,
               words: int, n_classes: int = 0) -> tuple[int, int]:
    """One dense encoder launch (XOR bind, channel and temporal majorities;
    with ``n_classes`` its Hamming AM epilogue): the codes, the (C, K, W)
    table and the (C, W) electrodes read once, frames or scores and
    predictions written; a word operation per (frame, cycle, word) for each
    channel and one for the temporal count.  Copied from
    ``chip_smoke.py:681-682``; the epilogue counted as the encoder's."""
    n_bytes = n_frames * window * channels + (channels * codes_k * words + channels * words) * 4
    n_ops = n_frames * window * words * (channels + 1)
    if n_classes:
        n_bytes += n_classes * words * 4 + n_frames * (n_classes + 1) * 4
        n_ops += n_frames * n_classes * words * 2
    else:
        n_bytes += n_frames * words * 4
    return n_bytes, n_ops


def codebook_bytes(hdc: dict) -> int:
    """The bytes of one patient's codebooks as the configuration states
    them: CompIM positions (C, K, S) + (C, S) uint8, or the dense packed
    tables (C, K, W) + (C, W) int32."""
    c, k = hdc["channels"], 1 << hdc["lbp_bits"]
    if hdc["variant"] == "dense":
        return (c * k + c) * hdc["dim"] // 8
    return c * k * hdc["segments"] + c * hdc["segments"]


def encode_work(hdc: dict, n_frames: int, n_classes: int = 0) -> tuple[int, int]:
    """The encoder's launch for this configuration's variant."""
    if hdc["variant"] == "dense":
        return dense_work(n_frames, hdc["window"], hdc["channels"], 1 << hdc["lbp_bits"],
                          hdc["dim"] // 32, n_classes)
    return encoder_work(n_frames, hdc["window"], hdc["channels"], 1 << hdc["lbp_bits"],
                        hdc["segments"], hdc["dim"] // hdc["segments"], n_classes)


def review_work(hdc: dict, t: int) -> tuple[int, int]:
    """One review request over a (t, channels) float32 recording: the
    signal, the patient's codebooks and class HVs read once, the scores and
    predictions written; the LBP and encoder operations (the codes between
    them are the algorithm's own and are not counted)."""
    c, bits, words = hdc["channels"], hdc["lbp_bits"], hdc["dim"] // 32
    k = hdc["n_classes"]
    f = (t - bits) // hdc["window"]
    n_bytes = t * c * 4 + codebook_bytes(hdc) + k * words * 4 + f * (k + 1) * 4
    n_ops = lbp_work(1, t, c, bits)[1] + encode_work(hdc, f, k)[1]
    return n_bytes, n_ops


def onboard_work(hdc: dict, t: int, epochs: int) -> tuple[int, int]:
    """One onboarding job over a (t, channels) labelled recording: the
    signal, the frame labels and the fresh codebooks read once, the bank
    written (threshold, class HVs, counter file and per-class frame counts).
    Operations: LBP, one encoding of every frame (the calibration's counts
    and the training frames come from the same encoding), the threshold's
    pass over the counts, and per epoch the AM (an AND and a popcount per
    frame, class and word) and the gated update (an add per frame, class
    and bit)."""
    c, bits, words, dim = hdc["channels"], hdc["lbp_bits"], hdc["dim"] // 32, hdc["dim"]
    k = hdc["n_classes"]
    f = (t - bits) // hdc["window"]
    n_bytes = (t * c * 4 + f * 4 + codebook_bytes(hdc)
               + 4 + k * words * 4 + k * dim * 4 + k * 4)
    n_ops = (lbp_work(1, t, c, bits)[1] + encode_work(hdc, f)[1]
             + f * dim + epochs * (f * k * words * 2 + f * k * dim))
    return n_bytes, n_ops
