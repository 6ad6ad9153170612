"""The port's packed-HV primitives and sparse core (repro_torch.core) held
against the JAX package's functions on the same numpy inputs.

Tolerance: exact equality.  The whole datapath is integer and bit
arithmetic, and the two float32 threshold rules repeat the reference's
operations in its order, so every output must match bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as j_am
from repro.core import binding as j_binding
from repro.core import bundling as j_bundling
from repro.core import classifier as j_classifier
from repro.core import hv as j_hv
from repro.core import im as j_im
from repro.core import online as j_online
from repro_torch.core import am, binding, bundling, classifier, hv, im, online

jax.config.update("jax_platform_name", "cpu")

# seg_len not a multiple of 32, non-power-of-two and tiny channel counts
# (the odd geometries of the reference's code-domain tests)
ODD_GEOMETRIES = [(192, 8, 6), (224, 7, 5), (256, 16, 3), (160, 5, 33)]


def _jit(fn, **static):
    """A reference function compiled once with its static arguments bound:
    the same integer operations, without the op-by-op dispatch that would
    dominate these tests' time."""
    return jax.jit(functools.partial(fn, **static))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(hv.to_i32(words).copy())


def _eq(got: torch.Tensor, want, words: bool = False) -> None:
    g = hv.to_u32(got) if words else got.numpy()
    np.testing.assert_array_equal(g, np.asarray(want))


# ---------------------------------------------------------------------------
# packing, popcount, elementwise ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 32), (3, 5, 64), (7, 1024)])
def test_pack_unpack_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    bits = rng.integers(0, 2, shape, dtype=np.uint8)
    packed = hv.pack_bits(torch.from_numpy(bits))
    _eq(packed, j_hv.pack_bits(jnp.asarray(bits)), words=True)
    words = _words(rng, *shape[:-1], shape[-1] // 32)
    _eq(hv.unpack_bits(_t(words)), j_hv.unpack_bits(jnp.asarray(words)))
    _eq(hv.unpack_bits(packed, shape[-1]), bits)


def test_popcount_overlap_hamming_match_reference():
    rng = np.random.default_rng(0)
    a, b = _words(rng, 9, 32), _words(rng, 9, 32)
    a[0] = 0xFFFFFFFF
    a[1] = 0x80000000
    _eq(hv.lax_popcount(_t(a)), j_hv.lax_popcount(jnp.asarray(a)))
    _eq(hv.popcount(_t(a)), j_hv.popcount(jnp.asarray(a)))
    _eq(hv.overlap(_t(a), _t(b)), j_hv.overlap(jnp.asarray(a), jnp.asarray(b)))
    _eq(hv.hamming(_t(a), _t(b)), j_hv.hamming(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_or_reduce_matches_reference(n):
    rng = np.random.default_rng(n)
    w = _words(rng, 4, n, 8)
    _eq(hv.or_reduce(_t(w), axis=-2),
        j_hv.or_reduce(jnp.asarray(w), axis=-2), words=True)


def test_bit_transpose_time_pack_bitplane_counts():
    rng = np.random.default_rng(1)
    w = _words(rng, 2, 96, 5)
    _eq(hv.bit_transpose32(_t(w[:, :32])),
        jax.jit(j_hv.bit_transpose32)(jnp.asarray(w[:, :32])), words=True)
    _eq(hv.time_pack(_t(w)), jax.jit(j_hv.time_pack)(jnp.asarray(w)), words=True)
    _eq(hv.bitplane_counts(_t(w), 160),
        _jit(j_hv.bitplane_counts, dim=160)(jnp.asarray(w)))


@pytest.mark.parametrize("n", [5, 32, 40])
def test_unpacked_counts_ragged_and_aligned(n):
    rng = np.random.default_rng(n)
    w = _words(rng, 3, n, 4)
    _eq(hv.unpacked_counts(_t(w), axis=1, dim=128),
        _jit(j_hv.unpacked_counts, axis=1, dim=128)(jnp.asarray(w)))


def test_threshold_and_majority_pack():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 20, (4, 3, 256)).astype(np.int32)
    thr = rng.integers(1, 15, (4, 1, 1)).astype(np.int32)
    _eq(hv.threshold_pack(torch.from_numpy(counts), torch.from_numpy(thr)),
        j_hv.threshold_pack(jnp.asarray(counts), jnp.asarray(thr)), words=True)
    _eq(hv.majority_pack(torch.from_numpy(counts), 19, 256),
        j_hv.majority_pack(jnp.asarray(counts), 19, 256), words=True)


def test_take_along_axis32_broadcasts_like_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 100, (4, 1, 10)).astype(np.int32)
    idx = rng.integers(0, 10, (1, 3, 2)).astype(np.int32)
    _eq(hv.take_along_axis32(torch.from_numpy(a), torch.from_numpy(idx), -1),
        j_hv.take_along_axis32(jnp.asarray(a), jnp.asarray(idx), -1))


@pytest.mark.parametrize("dim,segments,channels", ODD_GEOMETRIES + [(1024, 8, 4)])
def test_positions_to_packed_and_bundles(dim, segments, channels):
    rng = np.random.default_rng(dim + channels)
    seg_len = dim // segments
    pos = rng.integers(0, seg_len, (3, channels, segments), dtype=np.uint8)
    elec = rng.integers(0, seg_len, (channels, segments), dtype=np.uint8)
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    geo = dict(dim=dim, segments=segments)
    _eq(hv.positions_to_packed(tp, dim, segments),
        _jit(j_hv.positions_to_packed, **geo)(jp), words=True)
    bound = binding.bind_positions(tp, torch.from_numpy(elec), seg_len)
    jbound = j_binding.bind_positions(jp, jnp.asarray(elec), seg_len)
    _eq(bound, jbound)
    _eq(bundling.spatial_bundle_or_positions(bound, dim, segments),
        _jit(j_bundling.spatial_bundle_or_positions, **geo)(jbound), words=True)
    _eq(bundling.spatial_bundle_thinned_positions(bound, dim, segments, 2),
        _jit(j_bundling.spatial_bundle_thinned_positions, threshold=2, **geo)(jbound),
        words=True)


@pytest.mark.parametrize("dim,segments,channels", ODD_GEOMETRIES + [(1024, 8, 4)])
def test_naive_binding_matches_reference(dim, segments, channels):
    """The one-hot decoder, the barrel shift and the packed naive binding
    (including seg_len not a multiple of 32), and its equality with the
    position-domain binding."""
    rng = np.random.default_rng(dim * channels)
    seg_len = dim // segments
    geo = dict(dim=dim, segments=segments)
    pos = rng.integers(0, seg_len, (2, 3, channels, segments), dtype=np.uint8)
    elec = rng.integers(0, seg_len, (channels, segments), dtype=np.uint8)
    data = hv.positions_to_packed(torch.from_numpy(pos), dim, segments)
    epk = hv.positions_to_packed(torch.from_numpy(elec), dim, segments)
    _eq(hv.packed_to_positions(data, dim, segments), pos)
    _eq(hv.packed_to_positions(data, dim, segments),
        _jit(j_hv.packed_to_positions, **geo)(jnp.asarray(hv.to_u32(data))))
    bound = binding.bind_segmented_packed(data, epk, dim, segments)
    _eq(bound, _jit(j_binding.bind_segmented_packed, **geo)(
        jnp.asarray(hv.to_u32(data)), jnp.asarray(hv.to_u32(epk))), words=True)
    by_pos = binding.bind_positions(torch.from_numpy(pos),
                                    torch.from_numpy(elec), seg_len)
    assert torch.equal(bound, hv.positions_to_packed(by_pos, dim, segments))
    bits = rng.integers(0, 2, (4, dim), dtype=np.uint8)
    shifts = rng.integers(0, seg_len, (4, segments), dtype=np.uint8)
    _eq(binding.roll_segments_bits(torch.from_numpy(bits),
                                   torch.from_numpy(shifts), segments),
        _jit(j_binding.roll_segments_bits, segments=segments)(
            jnp.asarray(bits), jnp.asarray(shifts)))


@pytest.mark.parametrize("n", [5, 32, 33])
def test_bind_xor_and_packed_bundles_match_reference(n):
    rng = np.random.default_rng(n)
    a, b = _words(rng, 3, n, 8), _words(rng, n, 8)
    bound = binding.bind_xor(_t(a), _t(b))
    jbound = j_binding.bind_xor(jnp.asarray(a), jnp.asarray(b))
    _eq(bound, jbound, words=True)
    _eq(bundling.spatial_counts_packed(bound, 256),
        _jit(j_bundling.spatial_counts_packed, dim=256)(jbound))
    for thr in (1, n // 2, n + 1):
        _eq(bundling.spatial_bundle_thinned(bound, 256, thr),
            _jit(j_bundling.spatial_bundle_thinned, dim=256, threshold=thr)(jbound),
            words=True)
    _eq(bundling.spatial_bundle_or(bound), j_bundling.spatial_bundle_or(jbound),
        words=True)


def test_make_dense_im_draws_valid_tables():
    a = im.make_dense_im(torch.Generator().manual_seed(3), channels=6,
                         codes=64, dim=1024, device="cpu")
    b = im.make_dense_im(torch.Generator().manual_seed(3), channels=6,
                         codes=64, dim=1024, device="cpu")
    assert a.item_packed.shape == (6, 64, 32) and a.elec_packed.shape == (6, 32)
    assert a.item_packed.dtype == torch.int32 and a.dim == 1024
    assert torch.equal(a.item_packed, b.item_packed)
    assert torch.equal(a.elec_packed, b.elec_packed)
    # 6 * 64 * 1024 draws of p = 0.5: the density's standard deviation is
    # about 0.0008, so 0.49-0.51 is beyond 12 of them
    density = float(hv.popcount(a.item_packed).sum()) / (6 * 64 * 1024)
    assert 0.49 < density < 0.51
    assert not torch.equal(a.item_packed[0, 0], a.item_packed[0, 1])
    assert a.to("cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# classifier / im / am / online
# ---------------------------------------------------------------------------

def test_config_validation_matches_reference():
    for bad in (dict(dim=4096, segments=8), dict(dim=100), dict(window=0),
                dict(lbp_bits=9), dict(n_classes=0), dict(class_density=0.0),
                dict(dim=256, segments=7)):
        with pytest.raises(ValueError):
            j_classifier.HDCConfig(**bad)
        with pytest.raises(ValueError):
            classifier.HDCConfig(**bad)
    assert not hasattr(classifier.HDCConfig(), "backend")


def _params(cfg, seed):
    jparams = j_classifier.init_params(jax.random.PRNGKey(seed), cfg)
    tparams = im.IMParams(torch.from_numpy(np.asarray(jparams.item_pos).copy()),
                          torch.from_numpy(np.asarray(jparams.elec_pos).copy()),
                          cfg.dim, cfg.segments)
    return jparams, tparams


@pytest.mark.parametrize("dim,segments,channels,thinning", [
    geom + (i % 2 == 1,) for i, geom in enumerate(ODD_GEOMETRIES)])
def test_encode_frames_and_counts_match_reference(dim, segments, channels,
                                                  thinning):
    kw = dict(dim=dim, segments=segments, channels=channels, window=32,
              spatial_thinning=thinning, spatial_threshold=2,
              temporal_threshold=5)
    jcfg = j_classifier.HDCConfig(**kw)
    tcfg = classifier.HDCConfig(**kw)
    jparams, tparams = _params(jcfg, dim)
    rng = np.random.default_rng(channels)
    codes = rng.integers(0, 64, (2, 3 * 32 + 5, channels), dtype=np.uint8)
    _eq(im.im_lookup_positions(tparams, torch.from_numpy(codes)),
        j_im.im_lookup_positions(jparams, jnp.asarray(codes)))
    _eq(classifier.encode_frames(tparams, torch.from_numpy(codes), tcfg),
        _jit(j_classifier.encode_frames, cfg=jcfg)(jparams, jnp.asarray(codes)),
        words=True)
    counts = classifier.frame_counts(tparams, torch.from_numpy(codes), tcfg)
    jcounts = _jit(j_classifier.frame_counts, cfg=jcfg)(jparams, jnp.asarray(codes))
    _eq(counts, jcounts)
    for target in (0.1, 0.2, 0.25, 0.35, 0.5):
        # the reference's with_density_target, on the counts compiled above
        want = int(j_bundling.threshold_for_density(jcounts, target))
        assert (classifier.with_density_target(
                    tparams, torch.from_numpy(codes), tcfg, target)
                .temporal_threshold == want)


@pytest.mark.parametrize("target", [0.05, 0.2, 0.25, 0.3, 0.45, 0.5, 0.8])
def test_threshold_for_density_matches_reference(target):
    rng = np.random.default_rng(int(target * 100))
    counts = rng.integers(0, 257, (3, 11, 1024)).astype(np.int32)
    assert (int(bundling.threshold_for_density(torch.from_numpy(counts), target))
            == int(j_bundling.threshold_for_density(jnp.asarray(counts), target)))


@pytest.mark.parametrize("frames,total", [(95, 570), (49, 294), (3, 6), (1, 7)])
def test_threshold_for_density_mean_rounds_like_reference(frames, total):
    """Whole-number quantiles whose mean is exact: the reference's mean is
    a product with the float32 reciprocal of the count (570 * (1/95) is
    6.0000005), so its ceiling can sit one above the exact mean's."""
    per = np.full(frames, total // frames, np.int32)
    per[: total % frames] += 1
    counts = np.zeros((1, frames, 256), np.int32)
    counts[0, :, 153:] = per[:, None]      # quantile at 0.6 * 255 = 153
    assert (int(bundling.threshold_for_density(torch.from_numpy(counts), 0.4))
            == int(j_bundling.threshold_for_density(jnp.asarray(counts), 0.4)))


def test_am_scores_and_predict_match_reference():
    rng = np.random.default_rng(4)
    q, c = _words(rng, 5, 3, 8), _words(rng, 2, 8)
    q[0, 0] = c[0]  # ties in the argmax resolve low in both
    s = am.am_scores_sparse(_t(q), _t(c))
    _eq(s, j_am.am_scores_sparse(jnp.asarray(q), jnp.asarray(c)))
    _eq(am.am_scores_dense(_t(q), _t(c), 256),
        j_am.am_scores_dense(jnp.asarray(q), jnp.asarray(c), 256))
    tie = torch.tensor([[3, 3], [1, 2]], dtype=torch.int32)
    _eq(am.am_predict(tie), j_am.am_predict(jnp.asarray(tie.numpy())))
    _eq(am.am_predict(s), j_am.am_predict(
        j_am.am_scores_sparse(jnp.asarray(q), jnp.asarray(c))))


@pytest.mark.parametrize("density", [0.5, 0.25, 0.1])
def test_online_state_and_class_hvs_match_reference(density):
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (40, 256), dtype=np.uint8)
    labels = rng.integers(0, 3, 40).astype(np.int32)
    labels[:3] = (0, 1, 2)
    jstate = j_online.state_from_frames(jnp.asarray(bits), jnp.asarray(labels), 3)
    tstate = online.state_from_frames(torch.from_numpy(bits),
                                      torch.from_numpy(labels), 3)
    _eq(tstate.counts, jstate.counts)
    _eq(tstate.n, jstate.n)
    jcfg = j_classifier.HDCConfig(dim=256, n_classes=3, class_density=density)
    tcfg = classifier.HDCConfig(dim=256, n_classes=3, class_density=density)
    _eq(online.class_hvs_from_state(tstate, tcfg),
        j_online.class_hvs_from_state(jstate, jcfg), words=True)
    # a per-session density vector, as the fleet passes it
    dens = np.asarray([[0.5], [0.3]], np.float32)
    stacked_j = j_online.OnlineAMState(jnp.stack([jstate.counts] * 2),
                                       jnp.stack([jstate.n] * 2))
    stacked_t = online.OnlineAMState(torch.stack([tstate.counts] * 2),
                                     torch.stack([tstate.n] * 2))
    _eq(online.class_hvs_from_state(stacked_t, tcfg, torch.from_numpy(dens)),
        j_online.class_hvs_from_state(stacked_j, jcfg, jnp.asarray(dens)),
        words=True)


def test_dense_class_hvs_from_state_matches_reference():
    """Majority over the frames bundled per class, over max(n, 1) for a
    class with none; ties (count * 2 == n) give 0."""
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (30, 256), dtype=np.uint8)
    labels = rng.integers(0, 2, 30).astype(np.int32)
    labels[:2] = (0, 1)
    jstate = j_online.state_from_frames(jnp.asarray(bits), jnp.asarray(labels), 3)
    tstate = online.state_from_frames(torch.from_numpy(bits),
                                      torch.from_numpy(labels), 3)
    assert int(tstate.n[2]) == 0
    jcfg = j_classifier.HDCConfig(dim=256, n_classes=3, variant="dense")
    tcfg = classifier.HDCConfig(dim=256, n_classes=3, variant="dense")
    _eq(online.class_hvs_from_state(tstate, tcfg),
        j_online.class_hvs_from_state(jstate, jcfg), words=True)


def test_im_lookup_clamps_out_of_alphabet_codes_like_reference():
    jcfg = j_classifier.HDCConfig(dim=256, channels=5)
    jparams, tparams = _params(jcfg, 256)
    codes = np.random.default_rng(8).integers(0, 256, (4, 9, 5), dtype=np.uint8)
    codes[0, 0] = (63, 64, 65, 200, 255)
    _eq(im.im_lookup_positions(tparams, torch.from_numpy(codes)),
        j_im.im_lookup_positions(jparams, jnp.asarray(codes)))
    jnaive = j_im.make_im(jax.random.PRNGKey(8), channels=5, codes=64,
                          dim=256, segments=8)
    tnaive = im.IMParams(torch.from_numpy(np.asarray(jnaive.item_pos).copy()),
                         torch.from_numpy(np.asarray(jnaive.elec_pos).copy()),
                         256, 8).with_packed(True)
    _eq(tnaive.item_packed, jnaive.item_packed, words=True)
    _eq(tnaive.elec_packed, jnaive.elec_packed, words=True)
    _eq(im.im_lookup_packed(tnaive, torch.from_numpy(codes)),
        j_im.im_lookup_packed(jnaive, jnp.asarray(codes)),
        words=True)


def test_make_im_draws_valid_codebooks_from_generator():
    cfg = classifier.HDCConfig(dim=256, channels=6)
    a = im.make_im(torch.Generator().manual_seed(3), channels=6, codes=64,
                   dim=256, segments=8, device="cpu")
    b = im.make_im(torch.Generator().manual_seed(3), channels=6, codes=64,
                   dim=256, segments=8, device="cpu")
    assert a.item_pos.shape == (6, 64, 8) and a.item_pos.dtype == torch.uint8
    assert a.elec_pos.shape == (6, 8)
    assert int(a.item_pos.max()) < cfg.seg_len
    assert torch.equal(a.item_pos, b.item_pos) and torch.equal(a.elec_pos, b.elec_pos)
