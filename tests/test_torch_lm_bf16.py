"""The port's SSM and hybrid serving path in bfloat16, held against the JAX
package's bfloat16 run on the CPU.

Weights are the reference's, drawn in bfloat16 and carried across exactly
(``convert.lm_params_from_reference``); inputs are drawn with numpy.

- The mamba layer (reduced falcon-mamba-7b): ``_ssm_inputs``,
  ``mamba_prefill`` at L = 21 and at L = 300 (two scan chunks, the second
  padded) and three ``mamba_decode`` steps: every output in the reference's
  dtype (``da``, ``dbx``, ``c`` and the SSM state float32, the layer's
  output and conv tail bfloat16), within 3e-2 of the largest |value| of the
  reference's, as ``test_torch_lm_serve.py`` holds qwen3-0.6b's bfloat16
  logits.  The two packages round their bfloat16 products in another order
  (XLA on the CPU keeps float32 between fused bfloat16 operations), so one
  or two bfloat16 steps of difference are expected; the CPU read up to
  1.3e-2.  That bound cannot tell one cast order from another, so
  ``_ssm_inputs``'s float32 outputs must also equal the reference's, to
  float32 rounding (``rtol=1e-6``), on at least 80% of their elements: the
  CPU read 91-100%, and a bfloat16 rounding of ``dt`` or ``dt * b`` that is
  dropped, or one of ``dt * a`` that is added, reads 31-33% there.
- Serving (prefill and three greedy decode steps fed the reference's
  tokens): the logits and caches in the reference's dtypes, and the port's
  bfloat16 logits at most 1.5 times as far from a float64 run of the port
  on the same weights as the reference's bfloat16 logits are, plus 1e-2 of
  the largest |logit|.  reduced falcon-mamba-7b runs at the reference's
  init.  reduced jamba-1.5-large-398b is one period block, which the
  reference's init draws at std 1 (ROADMAP queue 3): there both packages'
  bfloat16 logits lie more than 100% of their largest value from the
  float64 answer, so nothing could be held; the hybrid case draws its
  stacked leaves at 1/sqrt(fan-in) instead (``_fan_in_spec``), where each
  package's bfloat16 logits lie within about 0.1 of it.
- The bfloat16 prefill/decode consistency at the reference's init, which
  ``chip_smoke.py`` phase 12 reports at full size: the port's is at most
  twice the reference's on the same weights and tokens, plus 1e-2.

Run as a script, the file prints, at falcon-mamba-7b's full width cut to
a few layers, batch 2 and a 64-token prompt, for a few prompt seeds: that
consistency for both packages, and each package's bfloat16 prefill logits'
distance from the port's float32 prefill on the same weights.  With
``--row-exact`` each bfloat16 matrix product of the port is taken in
float32 and rounded once, so a row's value no longer depends on the number
of rows in the product, as the reference's products on the CPU do not
(prefill multiplies B x L rows, decode B).  ``PERF.md`` cites it:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_bf16.py \
        --layers 2 4 8 [--row-exact]
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import mamba as j_mb
from repro.models import model as j_model
from repro.models import params as j_params
from repro.models import serve as j_serve
from repro.runtime.sharding import make_ctx
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import mamba, params, serve

jax.config.update("jax_platform_name", "cpu")

CTX = make_ctx(None)
BF16_TOL = 3e-2      # of the largest |value|, as qwen3-0.6b's bfloat16 logits
EQUAL_SHARE = 0.8    # least share of _ssm_inputs' elements equal to float32 rounding
BATCH, SEQ, GEN = 2, 21, 3


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _equal_share(got, want) -> float:
    """The share of elements within float32 rounding (rtol 1e-6)."""
    got, want = _f32(got), _f32(want)
    return float(np.mean(np.abs(got - want) <= 1e-6 * np.abs(want)))


def _same_dtype(got: torch.Tensor, want) -> bool:
    return str(got.dtype).removeprefix("torch.") == str(jnp.asarray(want).dtype)


def _fan_in_spec(spec):
    """The spec with every normal leaf that names no fan-in dims drawn at
    1/sqrt(its next-to-last dim), the fan-in of a (…, in, out) leaf."""
    def fix(s):
        if s.init in ("normal", "small") and not s.fan_in_dims and len(s.shape) >= 2:
            return j_params.ParamSpec(s.shape, s.axes, s.init, (len(s.shape) - 2,))
        return s
    return jax.tree.map(fix, spec, is_leaf=lambda s: isinstance(s, j_params.ParamSpec))


def _pair(jc, tc, fan_in: bool = False):
    """(reference bf16 weights, port bf16 weights) of one draw."""
    spec = j_model.model_spec(jc)
    tree = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(0), _fan_in_spec(spec) if fan_in else spec, jnp.bfloat16))
    return tree, convert.lm_params_from_reference(tc, tree, device="cpu").params()


def _cfgs(arch: str, **overrides):
    return (j_registry.get_config(arch).reduced(attn_kv_chunk=8, dtype="bfloat16", **overrides),
            registry.get_config(arch).reduced(attn_kv_chunk=8, dtype="bfloat16", **overrides))


# ---------------------------------------------------------------------------
# the mamba layer
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["ssm_inputs", "prefill_21", "prefill_300", "decode"])
def test_mamba_bf16_matches_reference(case):
    jc, tc = _cfgs("falcon-mamba-7b")
    jw = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(0), j_mb.mamba_spec(jc), jnp.bfloat16))
    tw = params.tree_map(lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16),
                         jw)
    rng = np.random.default_rng(1)
    pairs = []
    if case == "ssm_inputs":
        jx, tx = _bf16(rng.standard_normal((BATCH, 13, jc.d_inner), np.float32) * 0.5)
        mask = (np.arange(13) < 9).astype(np.float32)
        pairs += zip(("da", "dbx", "c"), mamba._ssm_inputs(tw, tx, tc, torch.from_numpy(mask)),
                     j_mb._ssm_inputs(jw, jx, jc, mask=mask))
        for name, got, want in pairs:
            share = _equal_share(got, want)
            assert share >= EQUAL_SHARE, f"{name}: {share:.3f} of the elements equal"
    elif case.startswith("prefill"):
        jx, tx = _bf16(rng.standard_normal((BATCH, int(case[8:]), jc.d_model), np.float32))
        got, gs = mamba.mamba_prefill(tw, tx, tc)
        want, ws = j_mb.mamba_prefill(jw, jx, jc, CTX)
        pairs += [("out", got, want), ("ssm", gs["ssm"], ws["ssm"]),
                  ("conv", gs["conv"], ws["conv"])]
    else:
        _, ws = j_mb.mamba_prefill(jw, _bf16(rng.standard_normal(
            (BATCH, 9, jc.d_model), np.float32))[0], jc, CTX)
        gs = {k: torch.from_numpy(_f32(v).copy()).to(
            torch.bfloat16 if k == "conv" else torch.float32) for k, v in ws.items()}
        for i in range(3):
            jx, tx = _bf16(rng.standard_normal((BATCH, 1, jc.d_model), np.float32))
            got, gs = mamba.mamba_decode(tw, tx, gs, tc)
            want, ws = j_mb.mamba_decode(jw, jx, ws, jc, CTX)
            pairs += [(f"out {i}", got, want), (f"ssm {i}", gs["ssm"], ws["ssm"]),
                      (f"conv {i}", gs["conv"], ws["conv"])]
    for name, got, want in pairs:
        assert _same_dtype(got, want), f"{name}: {got.dtype} against {jnp.asarray(want).dtype}"
        assert _rel(got, want) <= BF16_TOL, f"{name}: {_rel(got, want):.3g} of the largest value"


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _tokens(cfg, seq: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)


@pytest.mark.parametrize("arch,fan_in", [("falcon-mamba-7b", False),
                                         ("jamba-1.5-large-398b", True)])
def test_bf16_serving_as_near_float64_as_reference(arch, fan_in):
    """Prefill and GEN greedy decode steps (fed the reference's tokens) in
    bfloat16 on both sides, and in float64 on the port from the same
    weights: the logits' and caches' dtypes equal, and the port's worst
    distance from float64 at most 1.5 times the reference's + 1e-2."""
    jc, tc = _cfgs(arch)
    jw, tw = _pair(jc, tc, fan_in)
    p64 = params.tree_map(lambda a: a.double(), tw)
    c64 = dataclasses.replace(tc, dtype="float64")
    toks = _tokens(tc, SEQ)
    want, jcache = j_serve.prefill(jw, {"tokens": toks}, jc, CTX, SEQ + GEN)
    got, tcache = serve.prefill(tw, {"tokens": torch.from_numpy(toks)}, tc, SEQ + GEN)
    x64, cache64 = serve.prefill(p64, {"tokens": torch.from_numpy(toks)}, c64, SEQ + GEN)
    port_err, ref_err = [_rel(got, x64)], [_rel(want, x64)]
    for i in range(GEN):
        tok = np.argmax(_f32(want), -1)[:, None].astype(np.int32)
        want, jcache = j_serve.decode_step(jw, tok, jcache, jnp.int32(SEQ + i), jc, CTX)
        got, tcache = serve.decode_step(tw, torch.from_numpy(tok), tcache, SEQ + i, tc)
        x64, cache64 = serve.decode_step(p64, torch.from_numpy(tok), cache64, SEQ + i, c64)
        port_err.append(_rel(got, x64))
        ref_err.append(_rel(want, x64))
    assert _same_dtype(got, want)
    tflat, jflat = params.flatten(tcache), params.flatten(jcache)
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        assert _same_dtype(tflat[k], v), k
        assert bool(torch.isfinite(tflat[k]).all()), k
    assert max(port_err) <= 1.5 * max(ref_err) + 1e-2, (port_err, ref_err)


def _consistency(prefill, decode, toks) -> float:
    """Decode of the last token from the prefix's caches against prefill
    of the whole prompt: max |difference| over the largest |prefill logit|."""
    full = prefill(toks)[0]
    dec = decode(toks[:, -1:], prefill(toks[:, :-1])[1])
    return _rel(dec, full)


def _both_consistencies(jc, tc, jw, tw, toks) -> tuple[float, float]:
    seq = toks.shape[1]
    ref = _consistency(
        lambda t: j_serve.prefill(jw, {"tokens": t}, jc, CTX, seq),
        lambda t, c: j_serve.decode_step(jw, t, c, jnp.int32(seq - 1), jc, CTX)[0], toks)
    with torch.inference_mode():
        port = _consistency(
            lambda t: serve.prefill(tw, {"tokens": torch.from_numpy(t)}, tc, seq),
            lambda t, c: serve.decode_step(tw, torch.from_numpy(t), c, seq - 1, tc)[0], toks)
    return ref, port


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_bf16_consistency_tracks_reference(arch):
    jc, tc = _cfgs(arch)
    jw, tw = _pair(jc, tc)
    ref, port = _both_consistencies(jc, tc, jw, tw, _tokens(tc, 32))
    assert np.isfinite(port) and port <= 2 * ref + 1e-2, (port, ref)


def _row_exact_matmul():
    """Make the port's bfloat16 ``a @ b`` a float32 product rounded once."""
    plain = torch.Tensor.__matmul__

    def matmul(a, b):
        if a.dtype == torch.bfloat16:
            return plain(a.float(), b.float()).to(a.dtype)
        return plain(a, b)

    torch.Tensor.__matmul__ = matmul


def main(argv=None):
    ap = argparse.ArgumentParser(description="bfloat16 prefill/decode consistency of both "
                                 "packages at falcon-mamba-7b's full width, cut in depth")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--row-exact", action="store_true")
    args = ap.parse_args(argv)
    if args.row_exact:
        _row_exact_matmul()
    arch = "falcon-mamba-7b"
    for n in args.layers:
        jc = dataclasses.replace(j_registry.get_config(arch), n_layers=n, dtype="bfloat16")
        tc = dataclasses.replace(registry.get_config(arch), n_layers=n, dtype="bfloat16")
        c32 = dataclasses.replace(tc, dtype="float32")
        jw, tw = _pair(jc, tc)
        p32 = params.tree_map(lambda a: a.float(), tw)
        for seed in args.seeds:
            toks = _tokens(tc, args.prompt, seed)[:args.batch]
            ref, port = _both_consistencies(jc, tc, jw, tw, toks)
            with torch.inference_mode():
                t = {"tokens": torch.from_numpy(toks)}
                got = serve.prefill(tw, t, tc, args.prompt)[0]
                x32 = serve.prefill(p32, t, c32, args.prompt)[0]
            want = j_serve.prefill(jw, {"tokens": toks}, jc, CTX, args.prompt)[0]
            print(f"{arch} full width x {n} layers, bf16, batch {toks.shape[0]} x "
                  f"{args.prompt}, seed {seed}{', row-exact' if args.row_exact else ''}: "
                  f"consistency reference {ref:.4g}, port {port:.4g}; prefill logits from "
                  f"float32: reference {_rel(want, x32):.4g}, port {_rel(got, x32):.4g}",
                  flush=True)
        del jw, tw, p32


if __name__ == "__main__":
    main()
