"""The five ported kernels' plain versions (what each wrapper runs for CPU
tensors) held against the JAX package's Pallas kernels in interpret mode
and their ``ref.py`` oracles, on the same numpy inputs.

Tolerance: exact equality — every kernel is integer or bit arithmetic (LBP
compares floats but outputs the comparison bits).  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against
these plain versions there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as j_am
from repro.core import hv as j_hv
from repro.core.classifier import HDCConfig as JConfig
from repro.core import classifier as j_classifier
from repro.core.im import DenseIMParams as JDenseIMParams
from repro.core.im import IMParams as JIMParams
from repro.kernels.dense_hdc.kernel import dense_encoder_pallas
from repro.kernels.dense_hdc.ops import dense_encode_frames_fused as j_dense_fused
from repro.kernels.dense_hdc.ref import dense_encoder_ref as j_dense_ref
from repro.kernels.hdc_am.kernel import am_search_pallas
from repro.kernels.hdc_am.ops import am_search as j_am_search
from repro.kernels.hdc_am.ref import am_search_ref as j_am_ref
from repro.kernels.hdc_encoder.kernel import encoder_pallas
from repro.kernels.hdc_encoder.ops import encode_frames_fused as j_encode_fused
from repro.kernels.hdc_encoder.ref import encoder_ref as j_encoder_ref
from repro.kernels.hdc_fleet import ops as j_fleet_ops
from repro.kernels.hdc_fleet.kernel import fleet_counts_pallas
from repro.kernels.hdc_fleet.ref import emission_masks as j_emission_masks
from repro.kernels.lbp.kernel import lbp_pallas
from repro.kernels.lbp.ref import lbp_ref as j_lbp_ref
from repro.serve import dispatch as j_dispatch
from repro_torch.core import am, hv
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import DenseIMParams, IMParams
from repro_torch.kernels.dense_hdc import ops as dense_ops
from repro_torch.kernels.dense_hdc import ref as dense_ref
from repro_torch.kernels.common import stream_rows
from repro_torch.kernels.hdc_am import ops as am_ops
from repro_torch.kernels.hdc_encoder import ops as enc_ops
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.kernels.hdc_fleet import ref as fleet_ref
from repro_torch.kernels.lbp import ops as lbp_ops

jax.config.update("jax_platform_name", "cpu")


def _jit(fn, **static):
    """A reference function compiled once with its static arguments bound:
    the same integer operations, without the op-by-op dispatch that would
    dominate these tests' time."""
    return jax.jit(functools.partial(fn, **static))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(hv.to_i32(words).copy())


# ---------------------------------------------------------------------------
# lbp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,c,bits", [(1, 40, 4, 6), (2, 97, 5, 6),
                                        (3, 20, 64, 3), (1, 12, 7, 8)])
def test_lbp_plain_matches_pallas_and_ref(b, t, c, bits):
    rng = np.random.default_rng(t + c)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0, 3, 0] = x[0, 4, 0]            # equal neighbours compare false
    x[0, 7, c - 1] = np.nan            # NaN compares false
    got = lbp_ops.lbp_codes(torch.from_numpy(x), bits=bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_lbp_ref(jnp.asarray(x), bits=bits)))
    np.testing.assert_array_equal(
        got, np.asarray(lbp_pallas(jnp.asarray(x), bits=bits, interpret=True)))
    assert lbp_ops.lbp_codes.launches == 0   # CPU tensors never launch


def test_lbp_rejects_short_streams():
    with pytest.raises(ValueError):
        lbp_ops.lbp_codes(torch.zeros(1, 6, 3), bits=6)


# ---------------------------------------------------------------------------
# hdc_encoder
# ---------------------------------------------------------------------------

def _compim_operands(rng, lead, window, c, k, segments, seg_len):
    """Frame-viewed codes (some at and past K - 1), a CompIM table, the
    electrode positions, and the positions the reference gathers from them
    (out-of-alphabet codes clamp to K - 1)."""
    codes = rng.integers(0, min(k + 8, 256), (*lead, window, c), dtype=np.uint8)
    codes.reshape(-1, c)[0] = k - 1
    item = rng.integers(0, seg_len, (c, k, segments), dtype=np.uint8)
    elec = rng.integers(0, seg_len, (c, segments), dtype=np.uint8)
    pos = item[np.arange(c), np.minimum(codes, k - 1)]
    return codes, item, elec, pos


def _enc_plain(codes, item, elec, **kw):
    return hv.to_u32(enc_ops.encoder(torch.from_numpy(codes), torch.from_numpy(item),
                                     torch.from_numpy(elec), **kw))


@pytest.mark.parametrize("b,f,window,c,segments,seg_len,thinning,thr_s", [
    (2, 2, 64, 6, 8, 32, True, 2),
    (1, 2, 32, 5, 7, 32, False, 1),
    (1, 1, 32, 64, 8, 128, False, 1),     # paper-shaped channels
])
def test_encoder_plain_matches_pallas_and_ref(b, f, window, c, segments,
                                              seg_len, thinning, thr_s):
    """The wrapper's plain version (codes and CompIM table) against the
    reference's oracle and Pallas kernel on the positions gathered from
    the same table."""
    rng = np.random.default_rng(b * 100 + c)
    codes, item, elec, pos = _compim_operands(rng, (b, f), window, c, 64,
                                              segments, seg_len)
    kw = dict(window=window, segments=segments, seg_len=seg_len,
              temporal_threshold=max(1, window // 8),
              spatial_thinning=thinning, spatial_threshold=thr_s)
    got = _enc_plain(codes, item, elec, **kw)
    np.testing.assert_array_equal(
        got, np.asarray(_jit(j_encoder_ref, **kw)(jnp.asarray(pos), jnp.asarray(elec))))
    np.testing.assert_array_equal(
        got, np.asarray(_jit(encoder_pallas, interpret=True, **kw)(
            jnp.asarray(pos), jnp.asarray(elec))))
    assert enc_ops.encoder.launches == 0   # CPU tensors never launch


def test_encode_frames_fused_matches_reference_wrapper():
    kw = dict(dim=256, segments=8, channels=6, window=32, temporal_threshold=6)
    jcfg, tcfg = JConfig(**kw), HDCConfig(**kw)
    jparams = j_classifier.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = IMParams(torch.from_numpy(np.asarray(jparams.item_pos).copy()),
                       torch.from_numpy(np.asarray(jparams.elec_pos).copy()),
                       256, 8)
    codes = np.random.default_rng(2).integers(0, 64, (2, 100, 6), dtype=np.uint8)
    got = enc_ops.encode_frames_fused(tparams, torch.from_numpy(codes), tcfg)
    want = j_encode_fused(jparams, jnp.asarray(codes), jcfg, use_kernel=False)
    np.testing.assert_array_equal(hv.to_u32(got), np.asarray(want))


# (window, channels, segments, seg_len, lbp_bits, thinning, spatial threshold)
_ENC_CASES = [
    (1, 5, 7, 32, 6, False, 1),
    (31, 1, 8, 48, 3, True, 1),       # one channel, 8 codes: many past K - 1
    (40, 5, 7, 32, 6, True, 2),
    (48, 64, 8, 128, 6, False, 1),
    (256, 5, 8, 48, 3, True, 2),
    (32, 200, 8, 32, 6, True, 3),
    (64, 64, 8, 128, 6, True, 64),    # threshold C
    (32, 5, 7, 32, 6, True, 6),       # threshold C + 1: no spatial bit
    (32, 5, 7, 32, 6, True, 0),       # threshold 0: every spatial bit
    (40, 3, 8, 256, 4, False, 1),     # D = 2048
]


@pytest.mark.parametrize("window,c,segments,seg_len,lbp_bits,thinning,thr_s",
                         _ENC_CASES)
def test_encoder_new_operands_match_reference_wrapper(window, c, segments, seg_len,
                                                      lbp_bits, thinning, thr_s):
    """``encoder(codes, item_pos, elec)`` (plain on the CPU) against the
    reference's ``encode_frames_fused`` through its jnp oracle, and through
    the Pallas kernel in interpret mode where ``window % 32 == 0`` (the
    Pallas kernel drops ``window % 32`` cycles of every frame)."""
    dim = segments * seg_len
    cfg_kw = dict(dim=dim, segments=segments, channels=c, window=window,
                  lbp_bits=lbp_bits, spatial_thinning=thinning,
                  spatial_threshold=thr_s, temporal_threshold=max(1, window // 6))
    jcfg = JConfig(**cfg_kw)
    k = 1 << lbp_bits
    rng = np.random.default_rng(window * 1000 + c)
    codes, item, elec, _ = _compim_operands(rng, (2,), 2 * window + 3, c, k,
                                            segments, seg_len)
    codes = codes.reshape(2, 2 * window + 3, c)
    jparams = JIMParams(jnp.asarray(item), jnp.asarray(elec), dim, segments)
    f = codes.shape[1] // window
    got = _enc_plain(codes[:, :f * window].reshape(2, f, window, c), item, elec,
                     window=window, segments=segments, seg_len=seg_len,
                     temporal_threshold=jcfg.temporal_threshold,
                     spatial_thinning=thinning, spatial_threshold=thr_s)
    for use_kernel in (False, True) if window % 32 == 0 else (False,):
        want = _jit(j_encode_fused, cfg=jcfg, use_kernel=use_kernel)(
            jparams, jnp.asarray(codes))
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{use_kernel=}")


@pytest.mark.parametrize("window", [32, 40, 48, 64])
def test_encoder_follows_ref_where_pallas_drops_the_window_tail(window):
    """The reference's Pallas encoder loops over ``window // 32`` chunks of
    32 cycles, so it drops the last ``window % 32`` cycles of every frame
    (a fault of the reference, ROADMAP queue 3); the port computes the
    reference's ``encoder_ref`` at every window.  The Pallas kernel is held
    against the port only where ``window % 32 == 0``."""
    rng = np.random.default_rng(window)
    codes, item, elec, pos = _compim_operands(rng, (1, 2), window, 5, 64, 4, 32)
    kw = dict(window=window, segments=4, seg_len=32, temporal_threshold=3)
    got = _enc_plain(codes, item, elec, **kw)
    np.testing.assert_array_equal(
        got, np.asarray(_jit(j_encoder_ref, **kw)(jnp.asarray(pos), jnp.asarray(elec))))
    pallas = np.asarray(_jit(encoder_pallas, interpret=True, **kw)(
        jnp.asarray(pos), jnp.asarray(elec)))
    if window % 32 == 0:
        np.testing.assert_array_equal(got, pallas)


def test_encode_frames_fused_gathers_inside_the_kernel_on_cuda(monkeypatch):
    """For CUDA tensors ``encode_frames_fused`` hands the frame-viewed codes
    and the CompIM table to the kernel: no position tensor is gathered.
    The launch is recorded instead of run (no card here)."""
    import repro_torch.kernels.hdc_encoder.ref as enc_ref
    from repro_torch.kernels import build

    calls = []

    class Lib:
        def hdc_encoder_launch(self, *args):
            calls.append(args)
            return 0

    def no_gather(*args, **kwargs):
        raise AssertionError("the position gather ran")

    monkeypatch.setattr(enc_ops, "use_plain", lambda *t: False)
    monkeypatch.setattr(enc_ref, "im_lookup_positions", no_gather)
    monkeypatch.setattr(build, "lib", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(enc_ops.encoder, "launches", 0)
    cfg = HDCConfig(dim=256, segments=8, channels=6, window=32,
                    spatial_thinning=True, spatial_threshold=2,
                    temporal_threshold=5)
    rng = np.random.default_rng(3)
    params = IMParams(torch.from_numpy(rng.integers(0, 32, (6, 64, 8), dtype=np.uint8)),
                      torch.from_numpy(rng.integers(0, 32, (6, 8), dtype=np.uint8)),
                      256, 8)
    codes = torch.from_numpy(rng.integers(0, 64, (2, 100, 6), dtype=np.uint8))
    out = enc_ops.encode_frames_fused(params, codes, cfg)
    assert out.shape == (2, 3, 8) and enc_ops.encoder.launches == 1
    (args,) = calls
    assert args[4:13] == (6, 32, 6, 64, 8, 32, 5, 1, 2)
    assert args[1] == params.item_pos.data_ptr() and args[2] == params.elec_pos.data_ptr()


# ---------------------------------------------------------------------------
# numpy mirrors of the CUDA kernels' dataflow (csrc/hdc_encoder.cu, lbp.cu)
# ---------------------------------------------------------------------------

def _popcount32(v: np.ndarray) -> np.ndarray:
    return np.unpackbits(v.astype("<u4").view(np.uint8).reshape(*v.shape, 4),
                         axis=-1).sum(-1, dtype=np.int64)


def _warp_transpose(v: np.ndarray) -> np.ndarray:
    """warp_transpose32 (common.cuh) over axis 1, the 32 lanes."""
    lane = np.arange(32).reshape((1, 32) + (1,) * (v.ndim - 2))
    for i, m in enumerate([0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                           0x55555555]):
        s, m = 16 >> i, np.uint32(m)
        t = v[:, np.arange(32) ^ s]                            # __shfl_xor_sync
        v = np.where(lane & s, (v & ~m) | ((t & ~m) >> np.uint32(s)),
                     (v & m) | ((t & m) << np.uint32(s))).astype(np.uint32)
    return v


def _encoder_mirror(codes, item, elec, *, temporal_threshold, **kw):
    """hdc_encoder.cu in numpy: the frames' counts (``_counts_mirror``),
    then the frame-word epilogue's threshold and pack."""
    counts = _counts_mirror(codes, item, elec, **kw)
    n, d = counts.shape
    bits = (counts >= temporal_threshold).reshape(n, d // 32, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _counts_mirror(codes, item, elec, *, window, segments, seg_len,
                   spatial_thinning, spatial_threshold):
    """hdc_encoder.cu up to its epilogues, in numpy: the bound table as a
    block builds it, the launcher's choice of mode and planes, a lane per
    cycle rippling each position's one-hot (bit s * L + p, word k) up a
    saturating bit-sliced counter whose top plane is sticky, the top-down
    compare, then per 32-cycle group (a warp) the shuffle transpose and
    popcounts, the groups summed into (N, D) counts.  Lanes past the window
    leave zero rows."""
    n, _, c = codes.shape
    k, s, seg = item.shape[1], segments, seg_len
    d = s * seg
    w = d // 32
    v = item[:, :min(k, 256)].astype(np.int64) + elec[:, None, :]
    tab = np.where(v < seg, v, np.where(v - seg < seg, v - seg, v % seg))
    spat, thr, n_planes = -1, 1, 1
    if spatial_thinning:
        if spatial_threshold <= 0:
            spat = 1
        elif spatial_threshold > c:
            spat = 0
        else:
            thr = spatial_threshold
            while (1 << (n_planes - 1)) < thr:
                n_planes += 1
    groups = -(-window // 32)
    rows = np.zeros((n, groups * 32, w), np.uint32)
    if spat == 1:
        rows[:, :window] = _ONES
    elif spat == -1:
        planes = np.zeros((n_planes, n, window, w), np.uint32)
        bits = (np.arange(s) * seg
                + tab[np.arange(c), np.minimum(codes, k - 1)])   # (N, win, C, S)
        for ch in range(c):
            for si in range(s):
                b = bits[:, :, ch, si]
                kk = (b >> 5)[..., None]
                x = (np.uint32(1) << (b & 31).astype(np.uint32))[..., None]
                for p in range(n_planes - 1):              # atomicXor ripple
                    old = np.take_along_axis(planes[p], kk, -1)
                    np.put_along_axis(planes[p], kk, old ^ x, -1)
                    x = x & old
                top = planes[-1]                            # sticky atomicOr
                np.put_along_axis(top, kk, np.take_along_axis(top, kk, -1) | x, -1)
        spatial = planes[-1].copy()
        if n_planes > 1 and thr >> (n_planes - 1) == 0:
            gt, eq = np.zeros_like(spatial), np.full_like(spatial, _ONES)
            for p in reversed(range(n_planes - 1)):
                t = _ONES if (thr >> p) & 1 else np.uint32(0)
                gt |= eq & planes[p] & ~t
                eq &= ~(planes[p] ^ t)
            spatial |= gt | eq
        rows[:, :window] = spatial
    counts = np.zeros((n, d), np.int64)
    for g in range(groups):
        tv = _warp_transpose(rows[:, 32 * g:32 * g + 32])     # (N, lane b, W)
        counts += _popcount32(tv).transpose(0, 2, 1).reshape(n, d)
    return counts


@pytest.mark.parametrize("window,c,segments,seg_len,lbp_bits,thinning,thr_s",
                         _ENC_CASES)
def test_encoder_mirror_matches_plain(window, c, segments, seg_len, lbp_bits,
                                      thinning, thr_s):
    rng = np.random.default_rng(window * 7 + c)
    codes, item, elec, _ = _compim_operands(rng, (3,), window, c, 1 << lbp_bits,
                                            segments, seg_len)
    kw = dict(window=window, segments=segments, seg_len=seg_len,
              temporal_threshold=max(1, window // 6), spatial_thinning=thinning,
              spatial_threshold=thr_s)
    np.testing.assert_array_equal(_encoder_mirror(codes, item, elec, **kw),
                                  _enc_plain(codes, item, elec, **kw))


@pytest.mark.parametrize("thr", [0, 1, 2, 3, 4, 5, 64, 65])
def test_encoder_mirror_thresholds_and_wide_positions(thr):
    """Positions past L and codes past K - 1 (the table's modulo and the
    clamp), temporal thresholds 0 and window + 1, and spatial thresholds
    at and between powers of two (the top plane alone, or the compare)."""
    rng = np.random.default_rng(thr)
    window, c, s, seg = 40, 64, 8, 96
    codes, item, elec, _ = _compim_operands(rng, (2,), window, c, 16, s, seg)
    item = rng.integers(0, 256, item.shape, dtype=np.uint8)
    elec = rng.integers(0, 256, elec.shape, dtype=np.uint8)
    for tthr in (0, 5, window + 1):
        kw = dict(window=window, segments=s, seg_len=seg, temporal_threshold=tthr,
                  spatial_thinning=True, spatial_threshold=thr)
        np.testing.assert_array_equal(_encoder_mirror(codes, item, elec, **kw),
                                      _enc_plain(codes, item, elec, **kw))


def _counts_epilogue_mirror(flat, offset, rows, fpr, pitch, c, item, elec, *,
                            window, **kw):
    """hdc_encoder.cu's counts mode over a (B, T, C) stream read in place:
    frame n's codes from byte offset + (n // fpr) * pitch + (n % fpr) *
    window * C of the buffer (frame_codes), its counts as the shared mirror
    gives them, and the epilogue's store: lane b of the warp on word k
    writes count 32 k + b of frame n at n * D + 32 k + b."""
    n_frames = rows * fpr
    starts = offset + (np.arange(n_frames) // fpr) * pitch + (np.arange(n_frames) % fpr) * window * c
    frames = np.stack([flat[a:a + window * c] for a in starts]).reshape(n_frames, window, c)
    counts = _counts_mirror(frames, item, elec, window=window, **kw)
    d = counts.shape[1]
    out = np.full(n_frames * d, -1, np.int64)
    idx = (np.arange(n_frames)[:, None, None] * d + 32 * np.arange(d // 32)[None, :, None]
           + np.arange(32))
    out[idx] = counts.reshape(n_frames, d // 32, 32)
    return out.reshape(rows, fpr, d)


# (window, channels, segments, seg_len, lbp_bits, thinning, spatial threshold,
#  strided): the OR mode (one plane), thinning at 2 (two planes) and at 3
#  (planes read at run time), windows that are no multiple of 32, codes[1:]
_COUNTS_CASES = [
    (64, 6, 8, 32, 6, False, 1, True),
    (40, 5, 7, 32, 6, False, 1, False),
    (40, 5, 7, 32, 6, True, 2, True),
    (48, 64, 8, 128, 6, True, 3, True),
    (33, 9, 8, 48, 3, True, 3, False),
    (256, 64, 8, 128, 6, True, 2, True),
]


@pytest.mark.parametrize("window,c,segments,seg_len,lbp_bits,thinning,thr_s,strided",
                         _COUNTS_CASES)
def test_counts_epilogue_mirror_matches_plain_frame_counts(window, c, segments, seg_len,
                                                           lbp_bits, thinning, thr_s,
                                                           strided):
    """The counts epilogue (its mirror, reading a strided stream where it
    lies) against the plain ``classifier.frame_counts``, and the wrapper's
    plain version against both."""
    from repro_torch.core import classifier

    rng = np.random.default_rng(window * 31 + c)
    k = 1 << lbp_bits
    t = 3 * window + 5
    full, item, elec, _ = _compim_operands(rng, (3,), t, c, k, segments, seg_len)
    full = np.ascontiguousarray(full.reshape(3, t, c))
    view = torch.from_numpy(full)[1:] if strided else torch.from_numpy(full)
    fpr, pitch = stream_rows(view, window)
    offset = view.storage_offset()
    cfg = HDCConfig(dim=segments * seg_len, segments=segments, channels=c, window=window,
                    lbp_bits=lbp_bits, spatial_thinning=thinning, spatial_threshold=thr_s)
    params = IMParams(torch.from_numpy(item), torch.from_numpy(elec), cfg.dim, segments)
    want = classifier.frame_counts(params, view, cfg).numpy()
    got = _counts_epilogue_mirror(full.reshape(-1), offset, view.shape[0], fpr, pitch, c,
                                  item, elec, window=window, segments=segments,
                                  seg_len=seg_len, spatial_thinning=thinning,
                                  spatial_threshold=thr_s)
    np.testing.assert_array_equal(got, want)
    plain = enc_ops.frame_counts_fused(params, view, cfg)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    assert enc_ops.frame_counts_fused.launches == 0   # CPU tensors never launch


@pytest.mark.parametrize("thinning,thr_s", [(False, 2), (True, 2), (True, 3)])
def test_frame_counts_fused_plain_matches_reference(thinning, thr_s):
    """The counts wrapper's plain version against the reference's
    ``frame_counts`` for ``sparse_compim``, and, through the forced thinning
    the pipeline hands the kernel (``_fused_sparse_cfg``), for
    ``sparse_naive``'s bit-domain datapath."""
    from repro_torch.core import classifier
    from repro_torch.core.pipeline import _fused_sparse_cfg

    kw = dict(dim=256, segments=8, channels=6, window=40, spatial_thinning=thinning,
              spatial_threshold=thr_s)
    codes = np.random.default_rng(thr_s).integers(0, 64, (2, 3 * 40 + 7, 6), dtype=np.uint8)
    for variant in ("sparse_compim", "sparse_naive"):
        jcfg, tcfg = JConfig(variant=variant, **kw), HDCConfig(variant=variant, **kw)
        jparams = j_classifier.init_params(jax.random.PRNGKey(thr_s), jcfg)
        tparams = IMParams(torch.from_numpy(np.asarray(jparams.item_pos).copy()),
                           torch.from_numpy(np.asarray(jparams.elec_pos).copy()), 256, 8)
        want = np.asarray(_jit(j_classifier.frame_counts, cfg=jcfg)(jparams, jnp.asarray(codes)))
        got = enc_ops.frame_counts_fused(tparams, torch.from_numpy(codes),
                                         _fused_sparse_cfg(tcfg))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=variant)
        if variant == "sparse_naive":
            tparams = tparams.with_packed(True)
            np.testing.assert_array_equal(
                classifier.frame_counts(tparams, torch.from_numpy(codes), tcfg).numpy(), want)


def test_calibrate_density_counts_in_one_encoder_launch_on_cuda(monkeypatch):
    """For CUDA tensors ``HDCPipeline.calibrate_density`` takes its counts
    from one encoder launch with a counts output and no frame words or
    classes: no position tensor is gathered.  The launch is recorded
    instead of run (no card here); the recorder zeroes the counts it is
    handed, so the threshold is the density rule's floor."""
    import ctypes

    import repro_torch.core.im as im_mod
    import repro_torch.kernels.hdc_encoder.ref as enc_ref
    from repro_torch.core.pipeline import HDCPipeline
    from repro_torch.kernels import build

    calls = []

    class Lib:
        def hdc_encoder_launch(self, *args):
            calls.append(args)
            ctypes.memset(args[19], 0, args[4] * 256 * 4)
            return 0

    def no_gather(*args, **kwargs):
        raise AssertionError("the position gather ran")

    monkeypatch.setattr(enc_ops, "use_plain", lambda *t: False)
    monkeypatch.setattr(enc_ref, "im_lookup_positions", no_gather)
    monkeypatch.setattr(im_mod, "im_lookup_positions", no_gather)
    monkeypatch.setattr(build, "lib", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(enc_ops.encoder, "launches", 0)
    monkeypatch.setattr(enc_ops.frame_counts_fused, "launches", 0)
    cfg = HDCConfig(dim=256, segments=8, channels=6, window=32, temporal_threshold=5)
    pipe = HDCPipeline.init(torch.Generator().manual_seed(4), cfg, device="cpu")
    codes = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (2, 100, 6),
                                                               dtype=np.uint8))
    new = pipe.calibrate_density(codes[1:], target=0.25)
    assert new.cfg.temporal_threshold == 1
    assert (enc_ops.encoder.launches, enc_ops.frame_counts_fused.launches) == (1, 1)
    (args,) = calls
    assert args[3] is None and args[15:19] == (None, None, None, 0)   # no words, no AM
    assert args[19] is not None
    assert args[0] == codes[1:].data_ptr() and args[4:13] == (3, 32, 6, 64, 8, 32, 5, 0, 2)
    assert args[13:15] == (3, 100 * 6)
    assert args[1] == pipe.params.item_pos.data_ptr()


def test_frame_counts_fused_records_its_fake_launch():
    """On fake tensors (the dry-run) the counts wrapper records one encoder
    launch with the counts written in its bytes, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime import op_cost

    cfg = HDCConfig(dim=256, segments=8, channels=6, window=32)
    before = enc_ops.encoder.launches, enc_ops.frame_counts_fused.launches
    with FakeTensorMode():
        params = IMParams(torch.empty((6, 64, 8), dtype=torch.uint8),
                          torch.empty((6, 8), dtype=torch.uint8), 256, 8)
        codes = torch.empty((2, 100, 6), dtype=torch.uint8)
        with op_cost.OpCounter() as counter:
            out = enc_ops.frame_counts_fused(params, codes, cfg)
    assert out.shape == (2, 3, 256) and out.dtype == torch.int32
    want = enc_ops.work(6, 32, 6, 64, 8, 32, counts=True)
    assert want[0] == enc_ops.work(6, 32, 6, 64, 8, 32)[0] + 6 * (256 - 8) * 4
    assert counter.kernels == {"hdc_encoder": {"launches": 1, "bytes": want[0],
                                               "int_ops": want[1]}}
    assert (enc_ops.encoder.launches, enc_ops.frame_counts_fused.launches) == before


def _lbp_mirror(x: np.ndarray, bits: int, run: int = 32) -> np.ndarray:
    """lbp.cu in numpy: a thread per 4 channels (zero past C) and ``run``
    output steps; each sample read once, compared with the previous one,
    and shifted into 4 byte-wide codes of one word."""
    b, t, c = x.shape
    t_out, q = t - bits, -(-c // 4)
    xp = np.zeros((b, t, 4 * q), np.float32)
    xp[..., :c] = x
    xp = xp.reshape(b, t, q, 4)
    keep = np.uint32(((1 << bits) - 1) * 0x01010101)
    out = np.zeros((b, t_out, 4 * q), np.uint8)
    for bb in range(b):
        for t0 in range(0, t_out, run):
            n = min(run, t_out - t0) + bits
            prev, codes = xp[bb, t0], np.zeros(q, np.uint32)
            for i in range(1, n):
                cur = xp[bb, t0 + i]
                d = sum((cur[:, j] > prev[:, j]).astype(np.uint32) << np.uint32(8 * j)
                        for j in range(4))
                codes = (((codes << np.uint32(1)) & np.uint32(0xFEFEFEFE)) | d) & keep
                prev = cur
                if i >= bits:
                    out[bb, t0 + i - bits] = codes.astype("<u4").view(np.uint8)
    return out[..., :c]


@pytest.mark.parametrize("b,t,c,bits", [(2, 75, 7, 6), (1, 40, 65, 1),
                                        (1, 101, 65, 8), (3, 33, 8, 6),
                                        (1, 9, 4, 8), (2, 70, 64, 6)])
def test_lbp_mirror_matches_plain(b, t, c, bits):
    rng = np.random.default_rng(t * c + bits)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0, t // 2, 0] = np.nan
    x[-1, 3, c - 1] = np.nan
    x[0, 5, c // 2] = x[0, 4, c // 2]     # equal neighbours compare false
    want = lbp_ops.lbp_codes(torch.from_numpy(x), bits=bits).numpy()
    np.testing.assert_array_equal(_lbp_mirror(x, bits), want)


# ---------------------------------------------------------------------------
# hdc_am
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,words", [(1, 2, 32), (7, 2, 32), (300, 4, 32),
                                       (5, 8, 3), (9, 3, 32), (6, 3, 64),
                                       (40, 33, 64)])
@pytest.mark.parametrize("mode", ["overlap", "hamming"])
def test_am_plain_matches_pallas_and_ref(b, c, words, mode):
    rng = np.random.default_rng(b + c)
    q, cls = _words(rng, b, words), _words(rng, c, words)
    dim = words * 32
    got = am_ops.am_search(_t(q), _t(cls), mode=mode, dim=dim).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_am_ref(jnp.asarray(q), jnp.asarray(cls), mode=mode, dim=dim)))
    np.testing.assert_array_equal(
        got, np.asarray(am_search_pallas(jnp.asarray(q), jnp.asarray(cls),
                                         mode=mode, dim=dim, interpret=True)))


def test_am_leading_dims_and_bad_mode():
    rng = np.random.default_rng(0)
    q, cls = _words(rng, 3, 5, 8), _words(rng, 2, 8)
    out = am_ops.am_search(_t(q), _t(cls), mode="overlap", dim=256)
    assert out.shape == (3, 5, 2)
    with pytest.raises(ValueError):
        am_ops.am_search(_t(q), _t(cls), mode="cosine", dim=256)


# ---------------------------------------------------------------------------
# dense_hdc
# ---------------------------------------------------------------------------

def _dense_operands(rng, lead, window, c, k, w):
    """Frame-viewed codes (some out of the alphabet), the (C, K, W) table,
    the electrode HVs, and the item HVs the reference gathers from them
    (out-of-alphabet codes clamp within their channel)."""
    codes = rng.integers(0, k + 8, (*lead, window, c), dtype=np.uint8)
    table, elec = _words(rng, c, k, w), _words(rng, c, w)
    item_hvs = table[np.arange(c), np.minimum(codes, k - 1)]
    return codes, table, elec, item_hvs


def _dense_plain(codes, table, elec, window, w):
    out = dense_ops.dense_encoder(torch.from_numpy(codes), _t(table), _t(elec),
                                  window=window, dim=w * 32)
    return hv.to_u32(out)


@pytest.mark.parametrize("lead,window,c,k,w", [
    ((2, 3), 32, 5, 64, 8),
    ((1, 2), 16, 64, 64, 4),      # paper-shaped channels: channel ties
    ((3,), 48, 7, 5, 3),          # odd W and channels, tiny alphabet
])
def test_dense_plain_matches_pallas_and_ref(lead, window, c, k, w):
    """Windows that are multiples of 16, where the Pallas kernel's 16-cycle
    chunk loop covers every cycle."""
    rng = np.random.default_rng(window + c)
    codes, table, elec, item_hvs = _dense_operands(rng, lead, window, c, k, w)
    got = _dense_plain(codes, table, elec, window, w)
    kw = dict(window=window, dim=w * 32)
    np.testing.assert_array_equal(
        got, np.asarray(_jit(j_dense_ref, **kw)(jnp.asarray(item_hvs),
                                                jnp.asarray(elec))))
    hvs5 = item_hvs if len(lead) == 2 else item_hvs[None]   # (B, F, ...)
    want = _jit(dense_encoder_pallas, interpret=True, **kw)(
        jnp.asarray(hvs5), jnp.asarray(elec))
    np.testing.assert_array_equal(got, np.asarray(want).reshape(got.shape))


@pytest.mark.parametrize("window,c,w", [(40, 7, 3), (24, 6, 8), (33, 64, 2),
                                        (1, 5, 1)])
def test_dense_plain_matches_ref_at_every_window(window, c, w):
    """Every cycle of the window counts, also where window % 16 != 0 (the
    Pallas kernel drops those tail cycles; the reference's function is
    ``dense_encoder_ref``)."""
    rng = np.random.default_rng(window * c)
    codes, table, elec, item_hvs = _dense_operands(rng, (2, 2), window, c, 64, w)
    got = _dense_plain(codes, table, elec, window, w)
    want = _jit(j_dense_ref, window=window, dim=w * 32)(jnp.asarray(item_hvs),
                                                        jnp.asarray(elec))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("window,use_kernel", [(32, True), (32, False),
                                               (40, False)])
def test_dense_encode_frames_fused_matches_reference_wrapper(window, use_kernel):
    kw = dict(dim=256, channels=6, window=window, variant="dense")
    jcfg, tcfg = JConfig(**kw), HDCConfig(**kw)
    rng = np.random.default_rng(window)
    table, elec = _words(rng, 6, 64, 8), _words(rng, 6, 8)
    jparams = JDenseIMParams(jnp.asarray(table), jnp.asarray(elec), 256)
    tparams = DenseIMParams(_t(table), _t(elec), 256)
    codes = rng.integers(0, 70, (2, 3 * window + 7, 6), dtype=np.uint8)
    got = dense_ops.dense_encode_frames_fused(tparams, torch.from_numpy(codes), tcfg)
    want = j_dense_fused(jparams, jnp.asarray(codes), jcfg, use_kernel=use_kernel)
    np.testing.assert_array_equal(hv.to_u32(got), np.asarray(want))
    assert dense_ops.dense_encoder.launches == 0   # CPU tensors never launch


# ---------------------------------------------------------------------------
# hdc_fleet
# ---------------------------------------------------------------------------

def _fleet_operands(rng, s, t, c, k, w, p, window):
    tables = _words(rng, p, c, k, w)
    owner = rng.integers(0, p, s).astype(np.int32)
    codes = rng.integers(0, k + 8, (s, t, c), dtype=np.uint8)  # some OOA
    filled = rng.integers(0, window, s).astype(np.int32)
    lengths = rng.integers(0, t + 1, s).astype(np.int32)
    lengths[0] = 0
    return tables, owner, codes, filled, lengths


@pytest.mark.parametrize("s,t,c,k,w,window", [
    (4, 64, 6, 64, 8, 32),      # several slots per step
    (2, 96, 33, 8, 5, 32),      # odd W, channels just past a 32 boundary
])
@pytest.mark.parametrize("mode,threshold", [("or", 0), ("thin", 2),
                                            ("majority", 0)])
@pytest.mark.parametrize("masked", [False, True])
def test_fleet_kernel_plain_matches_pallas(s, t, c, k, w, window, mode,
                                           threshold, masked):
    rng = np.random.default_rng(s * 7 + c)
    tables, owner, codes, filled, lengths = _fleet_operands(
        rng, s, t, c, k, w, 3, window)
    tm = j_emission_masks(jnp.asarray(filled), jnp.asarray(lengths),
                          t_pad=t, window=window)
    tm_t = fleet_ref.emission_masks(torch.from_numpy(filled),
                                    torch.from_numpy(lengths),
                                    t_pad=t, window=window)
    np.testing.assert_array_equal(hv.to_u32(tm_t), np.asarray(tm))
    cm = None
    if masked:
        cm = (rng.random((s, c)) > 0.3).astype(np.uint32)
        cm[0] = 0                     # no live channel at all
    got = fleet_ops.fleet_counts_kernel(
        _t(tables), torch.from_numpy(owner), torch.from_numpy(codes), tm_t,
        mode=mode, dim=w * 32, threshold=threshold,
        chan_mask=None if cm is None else torch.from_numpy(cm.astype(np.int32)))
    want = fleet_counts_pallas(jnp.asarray(tables), jnp.asarray(owner),
                               jnp.asarray(codes), tm, mode=mode, dim=w * 32,
                               threshold=threshold,
                               chan_mask=None if cm is None else jnp.asarray(cm),
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t,window", [(40, 32), (100, 16)])
def test_fleet_counts_ref_and_fused_match_reference(t, window):
    """The prefix-count path on spatial words and the fused path on codes
    agree with the reference's jnp path, including ragged T (padded)."""
    cfg_kw = dict(dim=256, segments=8, channels=6, window=window)
    jcfg, tcfg = JConfig(**cfg_kw), HDCConfig(**cfg_kw)
    rng = np.random.default_rng(t)
    tables, owner, codes, filled, lengths = _fleet_operands(
        rng, 5, t, 6, 64, 8, 2, window)
    words = _jit(j_dispatch.owner_spatial_codes, cfg=jcfg)(
        jnp.asarray(tables), jnp.asarray(owner), jnp.asarray(codes))
    want = _jit(j_fleet_ops.fleet_counts, cfg=jcfg)(
        words, jnp.asarray(filled), jnp.asarray(lengths))
    got = fleet_ops.fleet_counts(_t(np.asarray(words)), torch.from_numpy(filled),
                                 torch.from_numpy(lengths), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fused = fleet_ops.fleet_counts_fused(
        _t(tables), torch.from_numpy(owner), torch.from_numpy(codes),
        torch.from_numpy(filled), torch.from_numpy(lengths), tcfg)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))


def test_spatial_mode_routes_like_reference():
    for kw in (dict(), dict(spatial_thinning=True, spatial_threshold=3),
               dict(variant="sparse_naive"), dict(variant="dense")):
        assert (fleet_ops.spatial_mode(HDCConfig(**kw))
                == j_fleet_ops.spatial_mode(JConfig(**kw)))


def test_bit_transpose_matches_ballot_order():
    """Plane b, bit j == bit b of cycle j: the LSB-first order the CUDA
    kernel's per-plane __ballot_sync produces."""
    rng = np.random.default_rng(9)
    x = _words(rng, 32, 3)
    planes = hv.to_u32(hv.bit_transpose32(_t(x)))
    bits = (x[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    want = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None, None]
            ).sum(0).astype(np.uint32)
    np.testing.assert_array_equal(planes, want)
    np.testing.assert_array_equal(planes,
                                  np.asarray(jax.jit(j_hv.bit_transpose32)(jnp.asarray(x))))


@pytest.mark.parametrize("seed", range(4))
def test_warp_transpose_matches_bit_transpose32(seed):
    """The kernels' five-stage shuffle transpose (common.cuh
    warp_transpose32), simulated over 32 lanes, gives lane b the word whose
    bit j is bit b of lane j: hv.bit_transpose32's order."""
    rng = np.random.default_rng(seed)
    v = _words(rng, 32)
    lane = np.arange(32)
    for i, m in enumerate([0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                           0x55555555]):
        s, m = 16 >> i, np.uint32(m)
        t = v[lane ^ s]                                    # __shfl_xor_sync
        v = np.where(lane & s, (v & ~m) | ((t & ~m) >> np.uint32(s)),
                     (v & m) | ((t & m) << np.uint32(s))).astype(np.uint32)
    want = hv.to_u32(hv.bit_transpose32(_t(_words(np.random.default_rng(seed), 32, 1))))
    np.testing.assert_array_equal(v, want[:, 0])


# ---------------------------------------------------------------------------
# bit-sliced channel counters (csrc/bitslice.cuh), mirrored in numpy
# ---------------------------------------------------------------------------

_ONES = np.uint32(0xFFFFFFFF)
_BS_CHANNELS = [1, 2, 3, 7, 8, 9, 16, 31, 32, 33, 63, 64, 65, 100, 127, 128,
                200, 255, 256, 257, 300]


def _bs_planes(c: int) -> int:
    """The plane count the launchers pick (bitslice_planes)."""
    return 8 if c <= 255 else 15


def _bs_count(words: np.ndarray, n_planes: int) -> list:
    """Channel words (C, ...) uint32 -> bit planes, as the kernels add them:
    per octet of channels (zero words pad the last) a carry-save tree of
    seven full adders into planes 0-2, then the weight-8 carry rippled up
    from plane 3 (BitCounter::add8)."""
    c = words.shape[0]
    x = np.zeros((-(-c // 8) * 8,) + words.shape[1:], np.uint32)
    x[:c] = words
    p = [np.zeros(words.shape[1:], np.uint32) for _ in range(n_planes)]

    def fa(s, a, b):  # sum, carry
        return s ^ a ^ b, (s & a) | (s & b) | (a & b)

    for o in range(0, x.shape[0], 8):
        q = x[o:o + 8]
        p[0], a1 = fa(p[0], q[0], q[1])
        p[0], b1 = fa(p[0], q[2], q[3])
        p[0], c1 = fa(p[0], q[4], q[5])
        p[0], d1 = fa(p[0], q[6], q[7])
        p[1], a2 = fa(p[1], a1, b1)
        p[1], b2 = fa(p[1], c1, d1)
        p[2], v = fa(p[2], a2, b2)
        for i in range(3, n_planes):
            p[i], v = p[i] ^ v, p[i] & v
        assert not v.any()  # the top carry is always 0
    return p


def _bs_at_least(p: list, thr: int) -> np.ndarray:
    """Bits whose count >= thr, top plane down (BitCounter::at_least)."""
    if thr <= 0:
        return np.full_like(p[0], _ONES)
    if thr >= 1 << len(p):
        return np.zeros_like(p[0])
    gt, eq = np.zeros_like(p[0]), np.full_like(p[0], _ONES)
    for i in reversed(range(len(p))):
        t = _ONES if (thr >> i) & 1 else np.uint32(0)
        gt |= eq & p[i] & ~t
        eq &= ~(p[i] ^ t)
    return gt | eq


def _bs_decode(p: list) -> np.ndarray:
    """Planes (...,) -> per-bit counts (..., 32)."""
    bit = np.arange(32, dtype=np.uint32)
    return sum(((pl[..., None] >> bit) & 1).astype(np.int64) << i
               for i, pl in enumerate(p))


def _per_bit_counts(words: np.ndarray) -> np.ndarray:
    """(C, ...) uint32 -> (..., 32) counts of each bit over C."""
    bit = np.arange(32, dtype=np.uint32)
    return ((words[..., None] >> bit) & 1).sum(0, dtype=np.int64)


def _bs_fleet_threshold(mode: str, thr: int, live: int, c: int,
                        masked: bool) -> int:
    """The kernel's per-session threshold: thin renormalises under a mask
    to max(1, ceil(thr * live / C)); majority is 2 cnt > n, i.e.
    cnt >= n // 2 + 1."""
    if mode == "thin":
        return max(1, (thr * live + c - 1) // c) if masked else thr
    return (live if masked else c) // 2 + 1


@pytest.mark.parametrize("c", _BS_CHANNELS)
@pytest.mark.parametrize("mode,mask_kind", [
    ("thin", None), ("thin", "dead"), ("thin", "live"), ("thin", "random"),
    ("majority", None), ("majority", "dead"), ("majority", "random")])
def test_bitsliced_counter_matches_fleet_plain(c, mode, mask_kind):
    """The fleet kernel's bit-sliced add, compare and per-session
    thresholds against ``fleet_counts_plain``: slot k of the plain version
    counts cycle k alone, so it returns every cycle's spatial bits."""
    rng = np.random.default_rng(1000 + c)
    p, s, k, w = 2, 3, 5, 2
    tables = _words(rng, p, c, k, w)
    tables[1, :, 0] = _ONES        # all channels on for code 0 of bank 1:
    owner = np.array([1, 0, 7], np.int32)  # out of range clamps to 1
    codes = rng.integers(0, k + 3, (s, 32, c), dtype=np.uint8)
    codes[0, :4] = 0               # ... so cycles 0-3 of session 0 count C
    tm = (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint32)
    tm = np.broadcast_to(tm[None, :, None], (s, 32, 1)).copy()
    mask = {None: None, "dead": np.zeros((s, c), np.int32),
            "live": np.ones((s, c), np.int32),
            "random": (rng.random((s, c)) < 0.5).astype(np.int32)}[mask_kind]
    ones = np.ones((s, c), np.int64) if mask is None else mask
    bound = tables[np.clip(owner, 0, p - 1)[:, None, None], np.arange(c),
                   np.minimum(codes, k - 1)]                  # (S, 32, C, W)
    bound = (bound * ones[:, None, :, None].astype(np.uint32)).astype(np.uint32)
    live = ones.sum(1)
    thresholds = [0, 1, c // 2, c, c + 1] if mode == "thin" else [0]
    for thr in thresholds:
        want = fleet_ref.fleet_counts_plain(
            _t(tables), torch.from_numpy(owner), torch.from_numpy(codes),
            _t(tm), mode=mode, dim=32 * w, threshold=thr,
            chan_mask=None if mask is None else torch.from_numpy(mask))
        want = want.numpy().reshape(s, 32, w, 32)             # bit of each cycle
        for si in range(s):
            planes = _bs_count(np.moveaxis(bound[si], 1, 0), _bs_planes(c))
            np.testing.assert_array_equal(
                _bs_decode(planes), _per_bit_counts(np.moveaxis(bound[si], 1, 0)))
            t_s = _bs_fleet_threshold(mode, thr, int(live[si]), c, mask is not None)
            got = _bs_at_least(planes, t_s)                   # (32, W)
            bits = (got[..., None] >> np.arange(32, dtype=np.uint32)) & 1
            np.testing.assert_array_equal(bits, want[si], err_msg=f"thr={thr}")
        if mask_kind == "dead":
            assert not want.any()      # live = 0 keeps no bit
        if mask is None and mode == "thin" and thr == c:
            assert want[0, :4].all()   # every channel on: count == C


@pytest.mark.parametrize("c", _BS_CHANNELS)
@pytest.mark.parametrize("window", [1, 2, 40, 64])
def test_bitsliced_counter_matches_dense_plain(c, window):
    """The dense kernel's channel counter and strict majority (cnt >=
    C // 2 + 1), then its temporal count (a popcount per 32-cycle chunk,
    zero cycles past the window), against ``dense_encoder_plain``.  At
    window 1 the frame is the cycle's spatial word; frame 0 forces an exact
    channel tie, and even windows give temporal ties."""
    rng = np.random.default_rng(2000 + c)
    n, k, w = 3, 6, 2
    codes = rng.integers(0, k + 2, (n, window, c), dtype=np.uint8)
    table, elec = _words(rng, c, k, w), _words(rng, c, w)
    codes[0] = 0
    table[:, 0] = 0
    table[:c // 2, 0] = _ONES ^ elec[:c // 2]   # bound: half the channels on
    bound = table[np.arange(c), np.minimum(codes, k - 1)] ^ elec  # (N, win, C, W)
    frames = np.zeros((n, w), np.uint32)
    ties = 0
    for f in range(n):
        planes = _bs_count(np.moveaxis(bound[f], 1, 0), _bs_planes(c))  # (win, W)
        counts = _bs_decode(planes)
        np.testing.assert_array_equal(counts,
                                      _per_bit_counts(np.moveaxis(bound[f], 1, 0)))
        ties += int((2 * counts == c).sum())
        spatial = _bs_at_least(planes, c // 2 + 1)
        pad = np.zeros((-(-window // 32) * 32, w), np.uint32)
        pad[:window] = spatial
        tcount = sum(_per_bit_counts(pad[j:j + 32]) for j in range(0, len(pad), 32))
        frames[f] = ((2 * tcount > window).astype(np.uint64)
                     << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    if c % 2 == 0:
        assert ties > 0
    want = dense_ref.dense_encoder_plain(torch.from_numpy(codes), _t(table),
                                         _t(elec), window=window, dim=32 * w)
    np.testing.assert_array_equal(frames, hv.to_u32(want))


# ---------------------------------------------------------------------------
# the encoders' AM epilogue (encode_score_fused) and the strided frame view
# ---------------------------------------------------------------------------

def _classes(rng, n_cls: int, words: int, tied: bool) -> np.ndarray:
    """Class rows; ``tied``: one row repeated, so every class scores the
    same and the prediction must be class 0."""
    rows = _words(rng, 1 if tied else n_cls, words)
    return np.repeat(rows, n_cls, axis=0) if tied else rows


def _j_score(frames, classes: np.ndarray, mode: str, dim: int):
    """The reference's AM on its frame HVs: the Pallas kernel in interpret
    mode, then ``am_predict``."""
    s = j_am_search(frames, jnp.asarray(classes), mode=mode, dim=dim, use_kernel=True)
    return np.asarray(s), np.asarray(j_am.am_predict(s))


# (n_classes, dim, window, tied, thinning): the reference's encoder runs the
# Pallas kernel (interpret mode) where window % 32 == 0 and its jnp oracle
# elsewhere (the Pallas kernel drops window % 32 cycles, ROADMAP queue 3)
_SCORE_CASES = [(1, 1024, 32, False, False), (2, 1024, 64, False, True),
                (3, 2048, 32, False, False), (3, 1024, 40, False, True),
                (2, 2048, 40, True, False), (3, 1024, 32, True, True)]


@pytest.mark.parametrize("n_cls,dim,window,tied,thinning", _SCORE_CASES)
def test_encode_score_fused_plain_matches_reference(n_cls, dim, window, tied, thinning):
    """``encode_score_fused`` (plain on the CPU) against the reference's
    ``am_search(encode_frames_fused(...))`` and ``am_predict`` on a strided
    batch slice ``codes[1:]`` whose T is no multiple of the window."""
    c = 6
    cfg_kw = dict(dim=dim, segments=8, channels=c, window=window,
                  spatial_thinning=thinning, spatial_threshold=2,
                  temporal_threshold=max(1, window // 8))
    jcfg, tcfg = JConfig(**cfg_kw), HDCConfig(**cfg_kw)
    rng = np.random.default_rng(n_cls * 1000 + dim + window)
    item = rng.integers(0, dim // 8, (c, 64, 8), dtype=np.uint8)
    elec = rng.integers(0, dim // 8, (c, 8), dtype=np.uint8)
    codes = rng.integers(0, 72, (3, 3 * window + 5, c), dtype=np.uint8)
    cls = _classes(rng, n_cls, dim // 32, tied)
    tparams = IMParams(torch.from_numpy(item), torch.from_numpy(elec), dim, 8)
    got_s, got_p = enc_ops.encode_score_fused(tparams, torch.from_numpy(codes)[1:],
                                              tcfg, _t(cls))
    jparams = JIMParams(jnp.asarray(item), jnp.asarray(elec), dim, 8)
    frames = _jit(j_encode_fused, cfg=jcfg, use_kernel=window % 32 == 0)(
        jparams, jnp.asarray(codes[1:]))
    want_s, want_p = _j_score(frames, cls, "overlap", dim)
    assert got_s.shape == (2, 3, n_cls) and got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    if tied:
        assert not got_p.any()
    assert enc_ops.encode_score_fused.launches == 0   # CPU tensors never launch


# (n_classes, dim, window, tied): the reference's Pallas dense kernel where
# window % 16 == 0, its jnp oracle elsewhere (ROADMAP queue 3)
_DENSE_SCORE_CASES = [(1, 1024, 32, False), (3, 2048, 16, False),
                      (2, 1024, 40, False), (3, 1024, 32, True),
                      (2, 2048, 24, True)]


@pytest.mark.parametrize("n_cls,dim,window,tied", _DENSE_SCORE_CASES)
def test_dense_encode_score_fused_plain_matches_reference(n_cls, dim, window, tied):
    """The dense ``encode_score_fused`` (plain on the CPU) against the
    reference's hamming ``am_search(dense_encode_frames_fused(...))`` and
    ``am_predict`` on a strided ``codes[1:]``."""
    c, w = 5, dim // 32
    kw = dict(dim=dim, channels=c, window=window, variant="dense")
    jcfg, tcfg = JConfig(**kw), HDCConfig(**kw)
    rng = np.random.default_rng(n_cls * 100 + dim + window)
    table, elec = _words(rng, c, 64, w), _words(rng, c, w)
    codes = rng.integers(0, 70, (3, 3 * window + 7, c), dtype=np.uint8)
    cls = _classes(rng, n_cls, w, tied)
    got_s, got_p = dense_ops.encode_score_fused(
        DenseIMParams(_t(table), _t(elec), dim), torch.from_numpy(codes)[1:], tcfg, _t(cls))
    frames = _jit(j_dense_fused, cfg=jcfg, use_kernel=window % 16 == 0)(
        JDenseIMParams(jnp.asarray(table), jnp.asarray(elec), dim), jnp.asarray(codes[1:]))
    want_s, want_p = _j_score(frames, cls, "hamming", dim)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    if tied:
        assert not got_p.any()
    assert dense_ops.encode_score_fused.launches == 0


def test_stream_rows_reads_strided_batches_in_place():
    """On the card the encoders read a (B, T, C) stream where it lies, cut
    to whole frames: each batch row contiguous, the rows any distance apart
    (codes[1:], codes[1::2]); a row that is not contiguous raises."""
    codes = torch.zeros(4, 1000, 64, dtype=torch.uint8)
    assert stream_rows(codes, 256) == (3, 1000 * 64)
    assert stream_rows(codes[1:], 256) == (3, 1000 * 64)
    assert stream_rows(codes[1::2], 300) == (3, 2 * 1000 * 64)
    assert stream_rows(codes[:, :512], 256) == (2, 1000 * 64)
    assert stream_rows(torch.zeros(5, 32, 1, dtype=torch.uint8)[:, ::1], 32) == (1, 32)
    with pytest.raises(ValueError, match="contiguous"):
        stream_rows(torch.zeros(5, 4, 32, dtype=torch.uint8).transpose(1, 2), 8)
    with pytest.raises(ValueError, match="contiguous"):
        stream_rows(codes[:, :, ::2], 256)


class _Recorder:
    """Stands in for the kernel library: records each launcher's arguments
    and reports success (there is no card here)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    """Every kernel wrapper takes the kernel path for CPU tensors and the
    launches are recorded instead of run."""
    from repro_torch.kernels import build
    rec = _Recorder()
    for mod in (enc_ops, dense_ops, am_ops):
        monkeypatch.setattr(mod, "use_plain", lambda *t: False)
    monkeypatch.setattr(build, "lib", lambda: rec)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    for fn in (enc_ops.encoder, enc_ops.encode_score_fused, dense_ops.dense_encoder,
               dense_ops.encode_score_fused, am_ops.am_search):
        monkeypatch.setattr(fn, "launches", 0)
    return rec


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_encode_score_fused_hands_the_strided_view_to_one_launch(fake_card, variant):
    """On the card the fused wrapper launches the encoder once with the
    class rows and no frame-word output, on the frame view where it lies:
    the codes pointer is codes[1:]'s, with 3 frames a row and rows T * C
    bytes apart (no copy)."""
    c, window, t = 6, 32, 3 * 32 + 5
    cfg = HDCConfig(dim=256, segments=8, channels=c, window=window,
                    temporal_threshold=5, variant=variant)
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 64, (3, t, c), dtype=np.uint8))
    cls = _t(_words(rng, 3, 8))
    if variant == "dense":
        params = DenseIMParams(_t(_words(rng, c, 64, 8)), _t(_words(rng, c, 8)), 256)
        ops, launcher = dense_ops, "dense_hdc_launch"
    else:
        params = IMParams(torch.from_numpy(rng.integers(0, 32, (c, 64, 8), dtype=np.uint8)),
                          torch.from_numpy(rng.integers(0, 32, (c, 8), dtype=np.uint8)),
                          256, 8)
        ops, launcher = enc_ops, "hdc_encoder_launch"
    scores, preds = ops.encode_score_fused(params, codes[1:], cfg, cls)
    assert scores.shape == (2, 3, 3) and preds.shape == (2, 3)
    ((name, args),) = fake_card.calls
    assert name == launcher and args[3] is None          # no frame words
    assert args[0] == codes[1:].data_ptr() == codes.data_ptr() + t * c
    if variant == "dense":
        assert args[4:11] == (6, window, c, 64, 8, 3, t * c)
        assert args[11] == cls.data_ptr() and args[15] == 3 and args[14] is not None
    else:
        assert args[4] == 6 and args[13:15] == (3, t * c)
        assert args[15] == cls.data_ptr() and args[18] == 3
    assert (ops.encode_score_fused.launches, am_ops.am_search.launches) == (1, 0)
    assert (enc_ops.encoder if variant != "dense" else dense_ops.dense_encoder).launches == 1


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_encode_score_fused_refuses_what_the_kernel_cannot_take(fake_card, variant):
    """A CUDA operand the fused kernel cannot take raises; nothing falls
    back to the unfused chain."""
    c = 4
    cfg = HDCConfig(dim=256, segments=8, channels=c, window=32, variant=variant)
    codes = torch.zeros(2, 64, c, dtype=torch.uint8)
    if variant == "dense":
        params = DenseIMParams(torch.zeros(c, 64, 8, dtype=torch.int32),
                               torch.zeros(c, 8, dtype=torch.int32), 256)
        ops = dense_ops
    else:
        params = IMParams(torch.zeros(c, 64, 8, dtype=torch.uint8),
                          torch.zeros(c, 8, dtype=torch.uint8), 256, 8)
        ops = enc_ops
    with pytest.raises(TypeError, match="class_hvs"):
        ops.encode_score_fused(params, codes, cfg, torch.zeros(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="class_hvs"):
        ops.encode_score_fused(params, codes, cfg, torch.zeros(2, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="class_hvs"):
        ops.encode_score_fused(params, codes, cfg, torch.zeros(0, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.encode_score_fused(params, codes.transpose(0, 1).contiguous().transpose(0, 1),
                               cfg, torch.zeros(2, 8, dtype=torch.int32))
    assert not fake_card.calls


# ---------------------------------------------------------------------------
# numpy mirrors of csrc/am.cuh and csrc/hdc_am.cu
# ---------------------------------------------------------------------------

def _am_emit_mirror(scores: np.ndarray) -> int:
    """am_emit's argmax: lane l keeps the best (score, class) of classes l,
    l + 32, ...; five xor-shuffle stages keep the better pair (a larger
    score, or an equal one at a lower class)."""
    lanes = [(-2**31, 2**31 - 1)] * 32

    def better(a, b):
        return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])

    for c, v in enumerate(scores):
        if better((int(v), c), lanes[c % 32]):
            lanes[c % 32] = (int(v), c)
    for s in (16, 8, 4, 2, 1):
        lanes = [lanes[i ^ s] if better(lanes[i ^ s], lanes[i]) else lanes[i]
                 for i in range(32)]
    assert len({p for p in lanes}) == 1   # every lane ends on the same pair
    return lanes[0][1]


@pytest.mark.parametrize("n_cls", [1, 2, 3, 32, 33, 100])
def test_am_emit_argmax_mirror_matches_am_predict(n_cls):
    """Ties (scores drawn from a few values) go to the lower class, as
    ``am_predict`` (torch.argmax) and the reference's ``jax.lax.argmax``."""
    rng = np.random.default_rng(n_cls)
    scores = rng.integers(0, 3, (40, n_cls)).astype(np.int32)
    scores[0] = 7
    got = np.asarray([_am_emit_mirror(row) for row in scores])
    np.testing.assert_array_equal(got, am.am_predict(torch.from_numpy(scores)).numpy())
    np.testing.assert_array_equal(got, np.asarray(j_am.am_predict(jnp.asarray(scores))))


def _hdc_am_mirror(q: np.ndarray, cls: np.ndarray, mode: str, dim: int,
                   threads: int = 256, ct: int = 8, stage_words: int = 12288,
                   max_blocks: int = 4096) -> np.ndarray:
    """hdc_am.cu's work split: R lanes a row (32, or the power of two >= W),
    32 / R rows a warp, a grid-stride loop over row groups, class chunks of
    what fits the staging buffer, AM_CT classes a pass; lane gl of a row's
    group stores class c where c % R == gl.  Each output is written once."""
    b, w = q.shape
    c = cls.shape[0]
    r = 1
    while r < w and r < 32:
        r *= 2
    g = 32 // r
    warps = threads // 32
    grid = min(-(-b // (warps * g)), max_blocks)
    cc = min(stage_words // w, c) if w <= stage_words else c
    out = np.full((b, c), -1, np.int64)
    pc = np.vectorize(lambda x: bin(int(x)).count("1"))
    for blk in range(grid):
        for c0 in range(0, c, cc):
            ncc = min(cc, c - c0)
            for warp in range(warps):
                rb = (blk * warps + warp) * g
                while rb < b:
                    for t0 in range(0, ncc, ct):
                        for j in range(min(ct, ncc - t0)):
                            k = c0 + t0 + j
                            for grp in range(g):
                                row = rb + grp
                                if row >= b:
                                    continue
                                parts = [q[row, wi] & cls[k, wi] if mode == "overlap"
                                         else q[row, wi] ^ cls[k, wi]
                                         for gl in range(r) for wi in range(gl, w, r)]
                                total = int(pc(np.asarray(parts, np.uint32)).sum())
                                assert out[row, k] == -1
                                out[row, k] = total if mode == "overlap" else dim - total
                    rb += grid * warps * g
    return out


@pytest.mark.parametrize("b,c,w", [(13, 3, 1), (9, 2, 3), (17, 9, 5), (5, 33, 32),
                                   (4, 2, 70), (3, 5, 13000)])
@pytest.mark.parametrize("mode", ["overlap", "hamming"])
def test_hdc_am_mirror_matches_plain(b, c, w, mode):
    """Every (row, class) of the standalone kernel's split is computed once
    and equals the plain version, for groups of 1, 4, 8 and 32 lanes, class
    tiles of 8, and rows too wide to stage (W = 13000)."""
    rng = np.random.default_rng(b * c + w)
    q, cls = _words(rng, b, w), _words(rng, c, w)
    want = am_ops.am_search(_t(q), _t(cls), mode=mode, dim=w * 32).numpy()
    np.testing.assert_array_equal(_hdc_am_mirror(q, cls, mode, w * 32), want)
