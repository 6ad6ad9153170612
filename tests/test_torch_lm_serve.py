"""The port's LM serving path held against the JAX package on the CPU:
``prefill`` (last-position logits and the caches) and greedy
``decode_step``s for the dense, VLM, MoE, SSM, hybrid and audio
(encoder-decoder) families at their reduced configs, the port's own
prefill/decode consistency, and the ``--arch`` CLI.

Weights are the reference's (``P.initialize(jax.random.PRNGKey(0),
M.model_spec(cfg), dtype)``) carried across with
``convert.lm_params_from_reference``; prompts are drawn with numpy.
``attn_kv_chunk`` is 8, so prefill attention runs several KV chunks, skips
the invisible ones and pads the last.

Tolerances: float32 logits and caches ``rtol=1e-4, atol=1e-4``, the SSM
state ``rtol=1e-3, atol=2e-4`` (the doubling scan reassociates), greedy
tokens and routed expert ids equal; bfloat16 (qwen3-0.6b reduced) max
absolute difference at most 3e-2 of the largest |logit|; consistency
(decode of token L from the prefix's cache against prefill's last logits)
``rtol=1e-3, atol=2e-4``, as the reference's own test holds it.

jamba-1.5-large-398b reduced is one period block, so the reference's init
draws every mamba and MLP leaf at std 1 (ROADMAP queue 3): dt and the SSM
state are large, and float32 itself is ill-conditioned there: exp(-e dt)
turns a float32 rounding of dt into a relative error dt times larger.  Its logits and
caches are held at 1e-2 of their largest |value| (``RELATIVE``), its
tokens and routed ids exactly, and both packages' float32 logits are held
at that bound against a float64 run of the port on the same tokens: the
port's float32 stands as near the float64 answer as the reference's.
falcon-mamba-7b's and seamless-m4t-medium's caches reach 20-40 and hold
values cancelled near zero, where an absolute 1e-4 asks for more than
float32 keeps at that scale after a few layers; their caches' ``atol`` is
taken times the cache's largest |value| (``SCALED``), their logits keep
the absolute tolerances.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import params as j_params
from repro.models import serve as j_serve
from repro.runtime.sharding import make_ctx
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import model, moe, params, serve
from repro_torch.runtime import steps

jax.config.update("jax_platform_name", "cpu")

CTX = make_ctx(None)
FAMILIES = ("qwen3-0.6b", "internvl2-2b", "deepseek-moe-16b", "falcon-mamba-7b",
            "jamba-1.5-large-398b", "seamless-m4t-medium")
RELATIVE = {"jamba-1.5-large-398b": 1e-2}
SCALED = ("falcon-mamba-7b", "seamless-m4t-medium")
FRAMES = 45          # encoder positions of an audio batch: 6 KV chunks of 8, the last padded
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ, GEN = 2, 21, 8


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(arch: str, wdtype=jnp.float32, **overrides):
    """(reference config, port config, reference weights, port model)."""
    jc = j_registry.get_config(arch).reduced(attn_kv_chunk=8, **overrides)
    tc = registry.get_config(arch).reduced(attn_kv_chunk=8, **overrides)
    tree = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(0), j_model.model_spec(jc), wdtype))
    return jc, tc, tree, convert.lm_params_from_reference(tc, tree, device="cpu")


def _batch(cfg, seq: int = SEQ, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, seq - n_media)).astype(np.int32)}
    if n_media:
        out["media"] = rng.standard_normal((BATCH, n_media, cfg.d_model), np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((BATCH, FRAMES, cfg.d_model), np.float32)
    return out


def _assert_close(arch: str, got, want, what: str, cache: bool = False):
    """float32 parity at the module's tolerances (an SSM state at its
    own); an arch in ``RELATIVE`` is held relative to its largest |value|,
    a cache of an arch in ``SCALED`` with ``atol`` times it."""
    got, want = _np(got), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if arch in RELATIVE:
        err = np.abs(got - want).max() / scale
        assert err <= RELATIVE[arch], f"{what}: {err:.3g} of the largest value"
        return
    rtol, atol = (1e-3, 2e-4) if what.endswith("ssm") else (1e-4, 1e-4)
    if cache and arch in SCALED:
        atol *= max(1.0, scale)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _assert_trees_close(arch: str, got: dict, want: dict):
    got, want = params.flatten(got), params.flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_close(arch, got[k], want[k], k, cache=True)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_greedy_decode_match_reference(monkeypatch, arch):
    """Prefill logits and caches, then 8 greedy decode steps (each step's
    logits, the tokens, the caches after the last step) through
    ``runtime.steps``; for MoE and the hybrid every MoE layer's routed
    expert ids, prefill and decode."""
    jc, tc, jw, m = _pair(arch)
    batch = _batch(tc)
    cache_seq = SEQ + GEN
    routed = {"port": [], "ref": []}

    def record_port(p, xf, cfg, route=moe._route):
        out = route(p, xf, cfg)
        routed["port"].append(_np(out[1]))
        return out

    def record_ref(p, xf, cfg, route=j_moe._route):
        out = route(p, xf, cfg)      # traced inside the reference's layer scan
        jax.debug.callback(lambda ids: routed["ref"].append(np.asarray(ids)), out[1],
                           ordered=True)
        return out

    monkeypatch.setattr(moe, "_route", record_port)
    monkeypatch.setattr(j_moe, "_route", record_ref)
    prefill, decode = steps.make_prefill(tc, cache_seq), steps.make_decode_step(tc)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, caches = prefill(m.params(), tbatch)
    want, j_caches = j_serve.prefill(jw, batch, jc, CTX, cache_seq)
    _assert_close(arch, got, want, "prefill logits")
    _assert_trees_close(arch, caches, j_caches)
    tok = got.argmax(-1)[:, None].to(torch.int32)
    j_tok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
    logits, toks = [(got, want)], []
    for i in range(GEN):
        np.testing.assert_array_equal(_np(tok), np.asarray(j_tok))
        toks.append(tok)
        got, caches = decode(m.params(), tok, caches, SEQ + i)
        want, j_caches = j_serve.decode_step(jw, j_tok, j_caches, jnp.int32(SEQ + i), jc, CTX)
        _assert_close(arch, got, want, f"logits of step {i}")
        logits.append((got, want))
        tok = got.argmax(-1)[:, None].to(torch.int32)
        j_tok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
    _assert_trees_close(arch, caches, j_caches)
    assert len(routed["port"]) == len(routed["ref"])
    n_moe = (tc.n_layers // 2 if tc.family == "hybrid"
             else (tc.n_layers - tc.first_k_dense) * tc.is_moe)
    assert len(routed["port"]) == n_moe * (GEN + 1)
    for got_ids, want_ids in zip(routed["port"], routed["ref"]):
        np.testing.assert_array_equal(got_ids, want_ids)
    if arch in RELATIVE:         # both float32 orders against a float64 run of the port
        monkeypatch.undo()
        c64 = dataclasses.replace(tc, dtype="float64")
        p64 = params.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float64)), jw)
        x64, c = serve.prefill(p64, tbatch, c64, cache_seq)
        for i, (g, w) in enumerate(logits):
            if i:
                x64, c = serve.decode_step(p64, toks[i - 1], c, SEQ + i - 1, c64)
            for name, y in (("port", g), ("reference", w)):
                err = np.abs(_np(y) - _np(x64)).max() / np.abs(_np(x64)).max()
                assert err <= RELATIVE[arch], f"{name} float32, step {i}: {err:.3g}"


def test_bf16_prefill_and_decode_close_to_reference():
    """qwen3-0.6b reduced in bfloat16 on both sides (the reference's bf16
    weights carried exactly): prefill and one decode step's logits within
    3e-2 of the largest |logit|."""
    jc, tc, jw, m = _pair("qwen3-0.6b", jnp.bfloat16, dtype="bfloat16")
    assert m.embed.dtype == torch.bfloat16
    batch = _batch(tc)
    got, caches = m.prefill({k: torch.from_numpy(v) for k, v in batch.items()}, SEQ + 1)
    want, j_caches = j_serve.prefill(jw, batch, jc, CTX, SEQ + 1)
    assert caches["k"].dtype == torch.bfloat16
    tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    got2, _ = m.decode_step(torch.from_numpy(tok), caches, SEQ)
    want2, _ = j_serve.decode_step(jw, tok, j_caches, jnp.int32(SEQ), jc, CTX)
    for g, w in ((got, want), (got2, want2)):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(_np(g) - w).max() <= 3e-2 * np.abs(w).max()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """Decoding token L from the cache of the prefix gives prefill's
    last-position logits on the whole prompt (the reference's
    ``test_prefill_decode_consistency``, on the port alone)."""
    cfg = registry.get_config(arch).reduced(attn_kv_chunk=8)
    m = model.LanguageModel.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seq=32).items()}
    tl = batch["tokens"].shape[1]
    full, _ = m.prefill(batch, 32)
    _, caches = m.prefill(dict(batch, tokens=batch["tokens"][:, :tl - 1]), 32)
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    dec, _ = m.decode_step(batch["tokens"][:, tl - 1:], caches, tl - 1 + n_media)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=1e-3, atol=2e-4, err_msg=arch)


def _cli(module: str, args: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)


def _shape(line: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?", "#", line.strip())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b", "seamless-m4t-medium"])
def test_arch_cli_prints_the_reference_lines(arch):
    """``--arch <arch> --reduced --device cpu`` exits 0 and prints the
    reference's lines (prefill, decode, greedy ids) in its format, with 6
    ids a row; the ids differ, since each package draws its weights from
    its own generator.  With qwen3, ``--mesh 2`` and ``--mesh 2
    --seq-sharded-kv`` (refused until the LM-on-a-mesh slice) run under
    ``torch.distributed.run --nproc-per-node 2``: rank 0 prints the same
    lines once, with the unsharded CLI's greedy ids."""
    args = ["--arch", arch, "--reduced", "--prompt-len", "24", "--gen", "6"]
    port = _cli("repro_torch.launch.serve", [*args, "--device", "cpu"])
    ref = _cli("repro.launch.serve", args)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    got = [_shape(ln) for ln in port.stdout.splitlines() if ln.strip()]
    want = [_shape(ln) for ln in ref.stdout.splitlines() if ln.strip()]
    assert got == want
    assert got[0] == "prefill: # x # tokens in # ms"
    assert got[1] == "decode: # steps in # ms (# tok/s)"
    ids = re.findall(r"\[(\d)\] \[([\d, ]+)\]", port.stdout)
    assert [len(row.split(",")) for _, row in ids] == [6, 6]
    if arch != "qwen3-0.6b":
        return
    for flag in (["--mesh", "2"], ["--mesh", "2", "--seq-sharded-kv"]):
        mesh = _cli("torch.distributed.run", ["--standalone", "--nproc-per-node", "2",
                                              "-m", "repro_torch.launch.serve", *args,
                                              "--device", "cpu", *flag])
        assert mesh.returncode == 0, mesh.stderr[-3000:]
        assert [_shape(ln) for ln in mesh.stdout.splitlines() if ln.strip()] == got, flag
        assert re.findall(r"\[(\d)\] \[([\d, ]+)\]", mesh.stdout) == ids, flag


def test_serving_functions_match_the_model_methods():
    """``LanguageModel.prefill``/``decode_step`` are the plain functions on
    the module's weights; ``init_caches`` has the prefill caches' layout."""
    cfg = registry.get_config("deepseek-moe-16b").reduced()
    m = model.LanguageModel.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator())}
    a, ca = m.prefill(batch, 12)
    b, cb = serve.prefill(m.params(), batch, cfg, 12)
    assert torch.equal(a, b)
    empty = serve.init_caches(cfg, 2, 12, torch.float32, device="cpu")
    for k, v in params.flatten(ca).items():
        assert torch.equal(v, params.flatten(cb)[k])
        assert params.flatten(empty)[k].shape == v.shape, k
    tok = a.argmax(-1)[:, None]
    a, ca = m.decode_step(tok, ca, 9)
    b, cb = serve.decode_step(m.params(), tok, cb, 9, cfg)
    assert torch.equal(a, b)
    assert all(torch.equal(v, params.flatten(cb)[k]) for k, v in params.flatten(ca).items())
