"""The port's LM zoo modules held against the JAX package on the CPU:
configs and parameter counts, parameter specs and initialisation, the
layers, chunked and decode attention, cross attention and the encoder, the
MoE router and both dispatches, and the weight carry
(``convert.lm_params_from_reference``).

Inputs are drawn with numpy from a seed and fed to both packages; weights
are the reference's (``P.initialize(jax.random.PRNGKey(0), ...)``) carried
across as numpy arrays.

Tolerances (float32 on both sides): configs, counts, shapes, routed
expert ids and dropped tokens exactly equal; ``rmsnorm``, ``apply_rope``
and ``mlp`` ``atol=1e-6``; ``_chunked_attention`` and the attention entry
points ``atol=2e-5``; ``encoder_forward`` ``rtol=1e-4, atol=1e-4``;
``moe_layer`` ``rtol=2e-4, atol=2e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hdc_ieeg as j_hdc_ieeg
from repro.configs import registry as j_registry
from repro.data import lm as j_lm
from repro.models import attention as j_attn
from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import params as j_params
from repro.models import serve as j_serve
from repro.runtime.sharding import make_ctx
from repro_torch import convert, device
from repro_torch.configs import hdc_ieeg, registry
from repro_torch.data import lm
from repro_torch.models import attention, config, layers, mamba, model, moe, params, serve

jax.config.update("jax_platform_name", "cpu")

CTX = make_ctx(None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jcfg(arch: str, **overrides):
    return j_registry.get_config(arch).reduced(**overrides)


def _tcfg(arch: str, **overrides):
    return registry.get_config(arch).reduced(**overrides)


def _weights(spec, seed: int = 0):
    """Reference weights as numpy and as the port's tensors."""
    tree = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(seed), spec, jnp.float32))
    return tree, params.tree_map(_t, tree)


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_config_and_param_count_match_reference(arch):
    """Every field of every config (full and reduced) and ``param_count``
    equal the reference's, and so do ``count_params`` of the spec and the
    spec's key paths, shapes and init kinds."""
    jc, tc = j_registry.get_config(arch), registry.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    for c_t, c_j in ((tc, jc), (tc.reduced(), jc.reduced())):
        assert config.param_count(c_t) == j_config.param_count(c_j)
        assert (c_t.resolved_head_dim, c_t.d_inner, c_t.dt_rank, c_t.is_moe,
                c_t.sub_quadratic) == (c_j.resolved_head_dim, c_j.d_inner,
                                       c_j.dt_rank, c_j.is_moe, c_j.sub_quadratic)
    for c_t, c_j in ((tc, jc), (tc.reduced(), jc.reduced())):
        spec_t, spec_j = model.model_spec(c_t), j_model.model_spec(c_j)
        assert params.count_params(spec_t) == j_params.count_params(spec_j)
        flat_j = {jax.tree_util.keystr(p, simple=True, separator="."): s
                  for p, s in jax.tree_util.tree_flatten_with_path(
                      spec_j, is_leaf=lambda s: isinstance(s, j_params.ParamSpec))[0]}
        flat_t = params.flatten(spec_t)
        assert list(flat_t) == list(flat_j)
        for k, s in flat_t.items():
            assert dataclasses.asdict(s) == dataclasses.asdict(flat_j[k]), k


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_every_config_builds_at_reduced(arch):
    """At ``reduced()``: ``LanguageModel.init`` holds the spec's leaves,
    ``init_caches`` has the layout (key paths, shapes, dtypes) of the
    reference's and of the port's own prefill caches, and a decode step
    runs on them; the decode input stand-ins match the reference's."""
    tc, jc = registry.get_config(arch).reduced(), j_registry.get_config(arch).reduced()
    m = model.LanguageModel.init(torch.Generator().manual_seed(0), tc, device="cpu")
    assert sorted(m.state_dict()) == sorted(params.flatten(model.model_spec(tc)))
    empty = params.flatten(serve.init_caches(tc, 2, 24, torch.float32, device="cpu",
                                             enc_len=16))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): v
            for p, v in jax.tree_util.tree_flatten_with_path(
                j_serve.init_caches(jc, 2, 24, jnp.float32, enc_len=16))[0]}
    assert sorted(empty) == sorted(want)
    for k, v in empty.items():
        assert tuple(v.shape) == want[k].shape and str(v.dtype)[6:] == str(want[k].dtype), k
    shape = lm.ShapeSpec("s", 20, 2, "prefill")
    batch = lm.synth_batch(torch.Generator().manual_seed(1), tc, shape)
    _, caches = m.prefill(batch, 24)
    if tc.family in ("encdec", "audio"):      # the cross caches follow the frames
        assert caches["ck"].shape[2] == 20
        empty.update(ck=caches["ck"], cv=caches["cv"])
    for k, v in params.flatten(caches).items():
        assert v.shape == empty[k].shape and v.dtype == empty[k].dtype, k
    tl = batch["tokens"].shape[1] + (tc.num_media_tokens if tc.family == "vlm" else 0)
    logits, _ = m.decode_step(batch["tokens"][:, -1:], caches, tl)
    assert tuple(logits.shape) == (2, tc.vocab) and bool(torch.isfinite(logits).all())
    got = params.flatten(lm.input_specs(tc, lm.SHAPES["decode_32k"]))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): v
            for p, v in jax.tree_util.tree_flatten_with_path(
                j_lm.input_specs(jc, j_lm.SHAPES["decode_32k"]))[0]}
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_unknown_family_raises():
    cfg = dataclasses.replace(_tcfg("qwen3-0.6b"), family="rnn")
    for call in (lambda: model.model_spec(cfg),
                 lambda: serve.init_caches(cfg, 1, 8, torch.float32, device="cpu")):
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            call()


def test_shape_applicability_matches_reference():
    got = [(a, s.name, ok, why) for a, _, s, ok, why in registry.all_cells()]
    want = [(a, s.name, ok, why) for a, _, s, ok, why in j_registry.all_cells()]
    assert got == want
    assert {k: dataclasses.asdict(v) for k, v in lm.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_registry.SHAPES.items()}


def test_hdc_ieeg_config_matches_reference():
    for name in ("CONFIG", "BASELINE"):
        want = dataclasses.asdict(getattr(j_hdc_ieeg, name))
        want.pop("backend")
        assert dataclasses.asdict(getattr(hdc_ieeg, name)) == want


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train"), ("internvl2-2b", "prefill"),
                                       ("deepseek-moe-16b", "decode"),
                                       ("falcon-mamba-7b", "decode"),
                                       ("jamba-1.5-large-398b", "decode"),
                                       ("seamless-m4t-medium", "prefill"),
                                       ("seamless-m4t-medium", "decode")])
def test_input_specs_and_synth_batch_shapes(arch, kind):
    """``input_specs`` (meta tensors) has the reference's shapes and
    dtypes; ``synth_batch`` draws those shapes on the generator's device;
    ``batch_for_step`` is a function of the step."""
    tc, jc = registry.get_config(arch), j_registry.get_config(arch)
    shape = lm.ShapeSpec("s", 4096, 8, kind)
    j_shape = j_lm.ShapeSpec("s", 4096, 8, kind)
    got = params.flatten(lm.input_specs(tc, shape))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): s
            for p, s in jax.tree_util.tree_flatten_with_path(
                j_lm.input_specs(jc, j_shape))[0]}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    small = registry.get_config(arch).reduced()
    sshape = lm.ShapeSpec("s", 24, 2, kind)
    batch = lm.synth_batch(torch.Generator().manual_seed(3), small, sshape)
    tl = lm.text_len(small, 24, kind)
    assert tuple(batch["tokens"].shape) == (2, 1 if kind == "decode" else tl)
    assert int(batch["tokens"].max()) < small.vocab
    if small.family == "vlm":
        assert tuple(batch["media"].shape) == (2, small.num_media_tokens, small.d_model)
    if small.family == "audio":
        if kind == "decode":
            assert batch["caches"]["ck"].shape[2] == lm.enc_len(24) == 16
        else:
            assert tuple(batch["frames"].shape) == (2, 24, small.d_model)
    again = lm.batch_for_step(small, sshape, 5, device="cpu")
    assert torch.equal(again["tokens"], lm.batch_for_step(small, sshape, 5, device="cpu")["tokens"])


# ---------------------------------------------------------------------------
# parameter specs, initialisation, the module and the carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sliced", [False, True])
def test_initialize_shapes_dtypes_and_seed(monkeypatch, sliced):
    """``initialize`` gives the spec's shapes and the asked dtype, the same
    values for the same seed and others for another, scales as the
    reference's (per leaf kind); ``sliced``: every leaf above 64 elements
    is drawn a first-dim slice at a time, as the full configs' large
    leaves are."""
    if sliced:
        monkeypatch.setattr(params, "SLICE_ELEMS", 64)
    cfg = _tcfg("deepseek-moe-16b", d_model=128, vocab=1024)
    spec = model.model_spec(cfg)
    a = params.initialize(torch.Generator().manual_seed(7), spec, torch.bfloat16)
    b = params.initialize(torch.Generator().manual_seed(7), spec, torch.bfloat16)
    c = params.initialize(torch.Generator().manual_seed(8), spec, torch.bfloat16)
    meta = params.abstract(spec, torch.bfloat16)
    for k, s in params.flatten(spec).items():
        ta = params.flatten(a)[k]
        assert tuple(ta.shape) == s.shape and ta.dtype == torch.bfloat16, k
        assert params.flatten(meta)[k].device.type == "meta"
        assert torch.equal(ta, params.flatten(b)[k]), k
        if s.init in ("zeros", "ones"):
            assert torch.equal(ta, torch.full(s.shape, float(s.init == "ones"),
                                              dtype=torch.bfloat16)), k
            continue
        assert not torch.equal(ta, params.flatten(c)[k]), k
        if ta.numel() >= 4096:
            std = float(ta.float().std())
            assert abs(std / params._scale(s) - 1) < 0.1, (k, std)
    ref = j_params.initialize(jax.random.PRNGKey(0), j_model.model_spec(
        _jcfg("deepseek-moe-16b", d_model=128, vocab=1024)), jnp.float32)
    for k, s in params.flatten(spec).items():   # the reference's scale per leaf
        x = np.asarray(params.flatten(jax.tree.map(np.asarray, ref))[k])
        if s.init not in ("zeros", "ones") and x.size >= 4096:
            assert abs(x.std() / params._scale(s) - 1) < 0.1, k


def test_language_model_holds_the_spec_paths():
    cfg = _tcfg("qwen3-0.6b")
    tree, _ = _weights(j_model.model_spec(_jcfg("qwen3-0.6b")))
    m = convert.lm_params_from_reference(cfg, tree, device="cpu")
    assert sorted(m.state_dict()) == sorted(params.flatten(model.model_spec(cfg)))
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(_np(v), params.flatten(tree)[k])
        assert not v.requires_grad
    assert m.device == torch.device("cpu")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "hybrid_stack"])
def test_convert_refuses_a_wrong_tree(fault):
    """A wrong leaf is named; ``hybrid_stack``: jamba's tree, whose mamba
    leaves are stacked twice (blocks, then sublayers), is carried whole and
    refused with one sublayer too few."""
    if fault == "hybrid_stack":
        cfg = _tcfg("jamba-1.5-large-398b")
        tree, _ = _weights(j_model.model_spec(_jcfg("jamba-1.5-large-398b")))
        m = convert.lm_params_from_reference(cfg, tree, device="cpu")
        np.testing.assert_array_equal(_np(m.blocks.mamba.mamba.a_log),
                                      tree["blocks"]["mamba"]["mamba"]["a_log"])
        tree["blocks"]["mamba"]["mamba"]["in_proj"] = tree["blocks"]["mamba"]["mamba"][
            "in_proj"][:, 1:]
        with pytest.raises(ValueError, match="leaf blocks.mamba.mamba.in_proj has shape"):
            convert.lm_params_from_reference(cfg, tree, device="cpu")
        return
    cfg = _tcfg("deepseek-moe-16b")
    tree, _ = _weights(j_model.model_spec(_jcfg("deepseek-moe-16b")))
    if fault == "missing":
        del tree["layers"]["moe"]["router"]
        match = r"missing leaves \['layers.moe.router'\]"
    elif fault == "extra":
        tree["layers"]["moe"]["bias"] = np.zeros(4, np.float32)
        match = r"unexpected leaves \['layers.moe.bias'\]"
    else:
        tree["embed"] = tree["embed"][:, :-1]
        match = "leaf embed has shape"
    with pytest.raises(ValueError, match=match):
        convert.lm_params_from_reference(cfg, tree, device="cpu")


def test_lm_entry_points_without_a_card_raise(monkeypatch):
    """Without a card, ``device=None`` raises at every LM entry point;
    nothing falls back to the CPU.  Training too: the optimizer state, the
    loss (a model's device is fixed when it is built, so ``loss`` is
    reached only through a model built on the card or on the CPU by
    request) and the launcher's loop."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tcfg("qwen3-0.6b")
    tree, weights = _weights(j_model.model_spec(_jcfg("qwen3-0.6b")))
    shape = lm.ShapeSpec("s", 8, 1, "prefill")
    train_shape = lm.ShapeSpec("t", 8, 1, "train")
    args = train.parser().parse_args(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])
    for call in (lambda: model.LanguageModel.init(torch.Generator(), cfg),
                 lambda: convert.lm_params_from_reference(cfg, tree),
                 lambda: serve.init_caches(cfg, 1, 8, torch.float32),
                 lambda: mamba.mamba_init_state(_tcfg("falcon-mamba-7b"), 1, torch.float32),
                 lambda: lm.batch_for_step(cfg, shape, 0),
                 lambda: adamw.init_state(weights, adamw.OptConfig()),
                 lambda: model.LanguageModel.init(torch.Generator(), cfg).loss(
                     lm.batch_for_step(cfg, train_shape, 0, device="cpu")),
                 lambda: train.train_loop(args),
                 lambda: train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1",
                                     "--ckpt-dir", "unused"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert device.resolve_device("cpu").type == "cpu"
    assert adamw.init_state(weights, adamw.OptConfig(), device="cpu")["step"].is_cpu
    m = model.LanguageModel(cfg, weights)
    loss, _ = m.loss(lm.batch_for_step(cfg, train_shape, 0, device="cpu"))
    assert loss.is_cpu and torch.isfinite(loss)
    with pytest.raises(ValueError, match="lies on meta"):
        m.loss({"tokens": torch.zeros((1, 8), dtype=torch.int32, device="meta"),
                "labels": torch.zeros((1, 8), dtype=torch.int32, device="meta")})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["rmsnorm", "rope_1d", "rope_2d_theta5e5", "mlp", "rope_freqs"])
def test_layer_ops_match_reference(op):
    rng = np.random.default_rng(0)
    if op == "rmsnorm":
        x = rng.standard_normal((2, 5, 64), np.float32) * 3
        s = rng.standard_normal(64, np.float32)
        got, want = layers.rmsnorm(_t(x), _t(s), 1e-6), j_layers.rmsnorm(x, s, 1e-6)
    elif op.startswith("rope"):
        if op == "rope_freqs":
            for hd, theta in ((16, 1e4), (128, 1e4), (128, 5e5)):
                np.testing.assert_array_equal(_np(layers.rope_freqs(hd, theta)),
                                              np.asarray(j_layers.rope_freqs(hd, theta)))
            return
        hd, theta = (16, 1e4) if op == "rope_1d" else (128, 5e5)
        x = rng.standard_normal((2, 7, 3, hd), np.float32)
        pos = (np.arange(7, dtype=np.int32) + 100 if op == "rope_1d"
               else rng.integers(0, 4000, (2, 7)).astype(np.int32))
        got, want = (layers.apply_rope(_t(x), _t(pos), theta),
                     j_layers.apply_rope(x, pos, theta))
    else:
        w = {k: rng.standard_normal(shp, np.float32) / 8
             for k, shp in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
        x = rng.standard_normal((2, 5, 64), np.float32)
        got = layers.mlp({k: _t(v) for k, v in w.items()}, _t(x))
        want = j_layers.mlp(w, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_zeroes_a_row_whose_mean_square_overflows(dtype):
    """A finite row whose float32 square overflows (|x| above about 1.8e19)
    normalises to zeros in both packages, a row just below it to the same
    values: the cause of the all-zero logits of a one-block jamba drawn at
    the reference's init at full width."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64), np.float32)
    x *= np.array([[1e30], [1e18], [1.0]], np.float32)
    s = rng.standard_normal(64, np.float32)
    got = layers.rmsnorm(_t(x).to(getattr(torch, dtype)), _t(s).to(getattr(torch, dtype)))
    want = j_layers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(s, dtype))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(_np(got.float())[0], 0.0)
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32))[0], 0.0)
    np.testing.assert_allclose(_np(got.float()), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-6, atol=0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,q_offset,lq,lk,q_block,h,kv", [
    (True, 0, 29, 29, 8, 4, 2),     # several q tiles, visible-chunk skip, padding
    (True, 5, 20, 25, 7, 4, 2),     # a prefix of 5 already cached
    (True, 0, 16, 16, 16, 2, 2),    # one tile, whole chunks
    (False, 0, 13, 29, 6, 4, 1),    # bidirectional (cross-like), G = 4
])
def test_chunked_attention_matches_reference(causal, q_offset, lq, lk, q_block, h, kv):
    rng = np.random.default_rng(1)
    hd = 16
    q = rng.standard_normal((2, lq, h, hd), np.float32)
    k = rng.standard_normal((2, lk, kv, hd), np.float32)
    v = rng.standard_normal((2, lk, kv, hd), np.float32)
    kw = dict(causal=causal, q_offset=q_offset, kv_chunk=8, q_block=q_block)
    got = attention._chunked_attention(_t(q), _t(k), _t(v), **kw)
    want = j_attn._chunked_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.2-3b"])
def test_attention_entry_points_match_reference(arch):
    """``attention_train``, ``attention_prefill`` (output and cache) and
    ``attention_decode`` (output and the cache written at ``pos``), with
    qk-norm (qwen3) and without (llama), at ``kv_chunk`` 8."""
    jc, tc = _jcfg(arch, attn_kv_chunk=8), _tcfg(arch, attn_kv_chunk=8)
    jw, tw = _weights(j_attn.attention_spec(jc), seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 19, jc.d_model), np.float32)
    got = attention.attention_train(tw, _t(x), tc)
    want = j_attn.attention_train(jw, x, jc, CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)
    got, (gk, gv) = attention.attention_prefill(tw, _t(x), tc)
    want, (wk, wv) = j_attn.attention_prefill(jw, x, jc, CTX)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=2e-5)
    s, pos = 24, 19
    kc = np.zeros((2, s, jc.n_kv_heads, jc.resolved_head_dim), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :pos], vc[:, :pos] = np.asarray(wk), np.asarray(wv)
    kc[:, pos + 1:] = 7.0      # stale rows past pos are masked out
    x1 = rng.standard_normal((2, 1, jc.d_model), np.float32)
    got, (gk, gv) = attention.attention_decode(tw, _t(x1), (_t(kc), _t(vc)), pos, tc)
    want, (wk, wv) = j_attn.attention_decode(jw, x1, (kc, vc), jnp.int32(pos), jc, CTX)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=2e-5)
    with pytest.raises(IndexError, match="outside the cache"):
        attention.attention_decode(tw, _t(x1), (_t(kc), _t(vc)), s, tc)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen3-0.6b"])
def test_cross_attention_matches_reference(arch):
    """``attention_spec(cross=True)`` (no qk-norm, even for qwen3),
    ``attention_cross`` over 29 encoder positions (several KV chunks, the
    last padded), ``cross_cache_from_encoder`` and
    ``attention_cross_decode`` over that cache."""
    jc, tc = _jcfg(arch, attn_kv_chunk=8), _tcfg(arch, attn_kv_chunk=8)
    spec = attention.attention_spec(tc, cross=True)
    assert sorted(spec) == sorted(j_attn.attention_spec(jc, cross=True)) == [
        "wk", "wo", "wq", "wv"]
    jw, tw = _weights(j_attn.attention_spec(jc, cross=True), seed=6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, jc.d_model), np.float32)
    enc = rng.standard_normal((2, 29, jc.d_model), np.float32)
    got = attention.attention_cross(tw, _t(x), _t(enc), tc)
    want = j_attn.attention_cross(jw, x, enc, jc, CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)
    gk, gv = attention.cross_cache_from_encoder(tw, _t(enc))
    wk, wv = j_attn.cross_cache_from_encoder(jw, enc)
    for g, w in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=2e-5)
    x1 = rng.standard_normal((2, 1, jc.d_model), np.float32)
    got = attention.attention_cross_decode(tw, _t(x1), (gk, gv), tc)
    want = j_attn.attention_cross_decode(jw, x1, (wk, wv), jc, CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)


def test_encoder_forward_matches_reference():
    """The bidirectional encoder (RoPE on, no causal mask) over 29 frames,
    then ``enc_norm``; the port's weights carried from the reference's."""
    jc, tc = _jcfg("seamless-m4t-medium", attn_kv_chunk=8), _tcfg("seamless-m4t-medium",
                                                                  attn_kv_chunk=8)
    jw, tw = _weights(j_model.model_spec(jc), seed=7)
    frames = np.random.default_rng(7).standard_normal((2, 29, jc.d_model), np.float32)
    got = model.encoder_forward(tw, _t(frames), tc)
    want = j_model.encoder_forward(jw, frames, jc, CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _drops(ids: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The routed (token, choice) slots past capacity, by the reference's
    rule: a stable sort by expert, then the first ``cap`` of each queue."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    for e in range(n_experts):
        sel = order[flat[order] == e]
        rank[sel] = np.arange(sel.size)
    return rank >= cap


@pytest.mark.parametrize("dispatch,capacity", [("dense", 8.0), ("index", 8.0),
                                               ("index", 0.25), ("local_index", 8.0),
                                               ("local_index", 0.25)])
def test_moe_layer_matches_reference(monkeypatch, dispatch, capacity):
    """Output and load-balance loss at ``rtol=2e-4, atol=2e-5``, routed ids
    equal; at capacity 0.25 tokens are dropped, the same ones (a different
    drop would move a whole expert's contribution)."""
    over = dict(n_experts=8, experts_per_token=2, moe_dispatch=dispatch,
                capacity_factor=capacity)
    jc, tc = _jcfg("deepseek-moe-16b", **over), _tcfg("deepseek-moe-16b", **over)
    jw, tw = _weights(j_moe.moe_spec(jc), seed=3)
    x = np.random.default_rng(4).standard_normal((2, 16, jc.d_model), np.float32)
    seen = {}

    def record(pkg, route):
        def wrapped(p, xf, cfg):
            out = route(p, xf, cfg)
            seen[pkg] = _np(out[1])
            return out
        return wrapped

    monkeypatch.setattr(moe, "_route", record("port", moe._route))
    monkeypatch.setattr(j_moe, "_route", record("ref", j_moe._route))
    got, aux = moe.moe_layer(tw, _t(x), tc)
    want, j_aux = j_moe.moe_layer(jw, x, jc, CTX)
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    cap = int(32 * 2 / 8 * capacity) + 1
    assert _drops(seen["port"], 8, cap).any() == (capacity < 1)


def test_route_ties_order_by_expert_id():
    """bfloat16 router products tie often; the top k then order by expert
    id as ``jax.lax.top_k`` orders them (duplicated router columns make
    every probability tie with another)."""
    jc = _jcfg("deepseek-moe-16b", n_experts=8, experts_per_token=3)
    tc = _tcfg("deepseek-moe-16b", n_experts=8, experts_per_token=3)
    rng = np.random.default_rng(5)
    half = rng.standard_normal((jc.d_model, 4), np.float32) / 8
    router = np.repeat(half, 2, axis=1)                  # columns 2i and 2i+1 equal
    x = rng.standard_normal((64, jc.d_model), np.float32)
    xb, rb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(router, jnp.bfloat16)
    jw, jid, _ = j_moe._route({"router": rb}, xb, jc)
    tw, tid, _ = moe._route({"router": _t(router).to(torch.bfloat16)},
                            _t(x).to(torch.bfloat16), tc)
    np.testing.assert_array_equal(_np(tid), np.asarray(jid))
    np.testing.assert_array_equal(_np(tw.float()), np.asarray(jw.astype(jnp.float32)))


def test_local_index_dispatch_raises(tmp_path):
    """``local_index`` over a mesh (it raised until the LM-on-a-mesh slice):
    on 2 gloo ranks (2x1, n_dp = 2) ``moe_layer`` equals the same dispatch
    computed unsharded with the tokens split into n_dp = 2 shards, each
    with its own capacity (the reference's ``_experts_local_index`` at
    n_dp = 2); at capacity 0.25 tokens drop, and the two shards' drops
    differ from one shard's (n_dp = 1), so the split is what is checked.
    Tolerance: ``test_moe_layer_matches_reference``'s."""
    import mesh_worker

    over = dict(n_experts=8, experts_per_token=2, moe_dispatch="local_index",
                capacity_factor=0.25)
    cfg = _tcfg("deepseek-moe-16b", **over)
    jw, tw = _weights(j_moe.moe_spec(_jcfg("deepseek-moe-16b", **over)), seed=3)
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model), np.float32)
    t, d, k, e = 32, cfg.d_model, cfg.experts_per_token, cfg.n_experts
    xf = _t(x).reshape(t, d)
    weights, ids, aux = moe._route(tw, xf, cfg)

    def dispatch(n_dp):
        cap = int(t // n_dp * k / e * cfg.capacity_factor) + 1
        disp, slot, wgt, st = moe._local_build(xf.reshape(n_dp, -1, d),
                                               weights.reshape(n_dp, -1, k),
                                               ids.reshape(n_dp, -1, k), e, cap)
        h = torch.nn.functional.silu(torch.einsum("secd,edf->secf", disp, tw["w_gate"]))
        h = h * torch.einsum("secd,edf->secf", disp, tw["w_up"])
        out_e = torch.einsum("secf,efd->secd", h, tw["w_down"])
        out = moe._local_gather_back(out_e, slot, wgt, st, t // n_dp).reshape(t, d)
        return (out + layers.mlp(tw["shared"], xf)).reshape(2, 16, d)

    want = dispatch(2)
    assert not torch.allclose(want, dispatch(1), atol=1e-3)
    np.testing.assert_array_equal(_np(moe.moe_layer(tw, _t(x), cfg)[0]), _np(dispatch(1)))
    work = tmp_path / "data"
    work.mkdir()
    np.savez(work / "moe.npz", x=x, out=_np(want), aux=_np(aux),
             **{f"w.{k}": v for k, v in params.flatten(jw).items()})
    mesh_worker.spawn("moe_local_index", {"mesh": [2, 1], "axes": ["data", "model"],
                                          "overrides": over, "n_dp": 2, "data": str(work)},
                      str(tmp_path / "group"))
