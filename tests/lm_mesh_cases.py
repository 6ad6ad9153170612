"""The parent's side of the LM-on-a-mesh tests (``tests/test_torch_lm_mesh*.py``;
not a test module): the unsharded reference's answers for one family,
written for the ranks of ``tests/mesh_worker.py``'s ``lm`` case, and the
spawn of those ranks.

The reference (JAX, ``reduced(attn_kv_chunk=8)``, float32) computes on
weights drawn with numpy from a seed (``weights``: each normal leaf at
std 1/sqrt(d_model), a tenth of it for "small", 0.02 for the embedding,
ones and zeros as the spec says: the scale ``test_torch_lm_train.py``'s
``rescaled`` gives the families where float32 is ill-conditioned at the
reference's own init, and a draw that takes no JAX compile): the loss, its
gradients and two AdamW steps at Adam eps 1e-4 (``grad_compress`` on for
one family), prefill of 2 x 24 positions and 8 greedy decode steps with
every step's logits, tokens and routed expert ids (and each routed
token's top-k margin), the caches after prefill and after the last step;
and the port's gradients in float64 on the same weights (the witness of a
gradient leaf that float32 itself leaves near the bound).
The local shapes each rank must hold come from the reference's own rules
(``to_pspec`` and ``_sanitize`` on a stand-in mesh): every parameter, and
every cache under the default and the ``seq_sharded_kv`` rules.  The
ranks import only torch and the port; they carry the weights across with
``convert.lm_params_from_reference``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as j_moe
from repro.models import serve as j_serve
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.runtime import sharding as j_shd
from repro.runtime import steps as j_steps
from repro_torch.models import params

import mesh_worker
from test_torch_lm_train import (CTX, OPT, configs, port_grads, reference_step,
                                 reference_value_and_grad, train_batch)
from test_torch_mesh import _stand_in

SERVE_BATCH, SERVE_SEQ, GEN, FRAMES = 2, 24, 8, 45
AXES = {2: ("data", "model")}


def weights(jc, seed: int = 0) -> dict:
    """A float32 weight tree of the reference's spec drawn with numpy."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, sp in params.flatten(j_model_spec(jc)).items():
        if sp.init in ("zeros", "ones"):
            flat[k] = np.full(sp.shape, 1.0 if sp.init == "ones" else 0.0, np.float32)
            continue
        std = {"embed": 0.02, "small": 0.1 / np.sqrt(jc.d_model)}.get(
            sp.init, 1.0 / np.sqrt(jc.d_model))
        flat[k] = (rng.standard_normal(sp.shape) * std).astype(np.float32)
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _flat(prefix: str, tree) -> dict:
    return {f"{prefix}.{k}": np.asarray(v) for k, v in
            params.flatten(jax.tree.map(np.asarray, tree)).items()}


def serve_batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab,
                                  (SERVE_BATCH, SERVE_SEQ - n_media)).astype(np.int32)}
    if n_media:
        out["media"] = rng.standard_normal((SERVE_BATCH, n_media, cfg.d_model), np.float32)
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal((SERVE_BATCH, FRAMES, cfg.d_model), np.float32)
    return out


def _local_shapes(prefix: str, tree, pspecs, sizes: dict) -> dict:
    """Each leaf's local shape under its reference ``PartitionSpec``."""
    out = {}
    flat_p = params.flatten(pspecs)
    for k, leaf in params.flatten(tree).items():
        shape = list(np.shape(leaf))
        for d, entry in enumerate(tuple(flat_p[k])):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            shape[d] //= int(np.prod([sizes[n] for n in names]))
        out[f"{prefix}.{k}"] = np.asarray(shape, np.int64)
    return out


def _pspecs(build, mesh_shape: tuple, seq_sharded_kv: bool = False):
    """``build(ctx)`` with the reference's ``sharding_for`` answering a
    sanitised ``PartitionSpec`` on a stand-in mesh (no devices)."""
    names = AXES[len(mesh_shape)]
    stand_in = _stand_in(mesh_shape, names)
    ctx = j_shd.ShardCtx(stand_in, j_shd._base_rules(names))
    if seq_sharded_kv:
        r = dict(ctx.rules)
        ctx = j_shd.ShardCtx(stand_in, r | {"batch": (), "kv_seq": r["fsdp"],
                                            "kv_tp": ("model",)})

    def pspec(axes, ctx_, shape=None):
        return j_shd._sanitize(j_shd.to_pspec(axes, ctx_.rules), shape, ctx_.mesh)

    saved = (j_shd.sharding_for, j_steps.sharding_for)
    j_shd.sharding_for = j_steps.sharding_for = pspec
    try:
        return build(ctx)
    finally:
        j_shd.sharding_for, j_steps.sharding_for = saved


def _route_recorder(log: list):
    orig = j_moe._route

    def route(p, xf, cfg):
        out = orig(p, xf, cfg)
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, p["router"]).astype(jnp.float32))
        top = jax.lax.top_k(probs, cfg.experts_per_token + 1)[0]
        jax.debug.callback(lambda ids, m: log.append((np.asarray(ids), np.asarray(m))),
                           out[1], top[:, -2] - top[:, -1], ordered=True)
        return out
    return orig, route


def write_case(work: str, arch: str, *, meshes: list, grad_compress: bool = False,
               seq_sharded_kv: bool = False, **overrides) -> dict:
    """The reference's answers for ``arch`` (``overrides`` to its reduced
    config) into ``work/<name>.npz``; -> the case's entry of the ranks'
    spec."""
    name = "-".join([arch] + [f"{k}={v}" for k, v in sorted(overrides.items())])
    jc, tc = configs(arch, **overrides)
    tree = weights(jc)
    out = _flat("w", tree)

    # train: loss, gradients, two steps
    batch = train_batch(jc)
    out.update({f"tb.{k}": v for k, v in batch.items()})
    (jl, jm), jg = reference_value_and_grad(jc)(tree, batch)
    out.update({"loss": np.asarray(jl), "xent": np.asarray(jm["xent"]),
                "aux": np.asarray(jm["aux"])})
    out.update(_flat("g", jg))
    # the float64 witness of a gradient leaf the mesh holds beyond GRAD_TOL
    out.update({f"g64.{k}": v.numpy() for k, v in
                port_grads(tc, tree, batch, torch.float64)[2].items()})
    jopt = j_adamw.OptConfig(**OPT)
    jp, js = jax.tree.map(jnp.asarray, tree), j_adamw.init_state(tree, jopt)
    if grad_compress:
        jstep = jax.jit(j_steps.make_train_step(jc, jopt, CTX, grad_compress=True))
        res = j_compress.init_residual(jp)
    else:
        jstep = reference_step(jc, jopt)
    for i in range(2):
        if grad_compress:
            jp, js, res, loss, met = jstep(jp, js, batch, res)
        else:
            jp, js, loss, met = jstep(jp, js, batch)
        out[f"s{i}.loss"] = np.asarray(loss)
        for k in ("xent", "aux", "grad_norm", "lr"):
            out[f"s{i}.{k}"] = np.asarray(met[k])
        out.update(_flat(f"p{i}", jp))

    # serve: prefill, 8 greedy steps, routed ids and their margins
    sb = serve_batch(jc)
    out.update({f"sb.{k}": v for k, v in sb.items()})
    routed: list = []
    orig, route = _route_recorder(routed)
    j_moe._route = route
    try:
        cache_seq = SERVE_SEQ + GEN
        prefill = jax.jit(lambda p, b: j_serve.prefill(p, b, jc, CTX, cache_seq))
        decode = jax.jit(lambda p, t, c, pos: j_serve.decode_step(p, t, c, pos, jc, CTX))
        logits, caches = prefill(tree, sb)
        out.update(_flat("pc", caches))
        for i in range(GEN + 1):
            out[f"logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out[f"tok{i}"] = np.asarray(tok)
            if i < GEN:
                logits, caches = decode(tree, tok, caches, jnp.int32(SERVE_SEQ + i))
        jax.effects_barrier()
    finally:
        j_moe._route = orig
    out.update(_flat("c", caches))
    for i, (ids, margin) in enumerate(routed):
        out[f"ids{i}"], out[f"margin{i}"] = ids, margin

    # local shapes by the reference's rules, each mesh (and seq_sharded_kv)
    for shape in meshes:
        tag = "x".join(map(str, shape))
        sizes = dict(zip(AXES[len(shape)], shape))
        ps = _pspecs(lambda ctx: j_shd.tree_shardings(j_model_spec(jc), ctx), shape)
        out.update(_local_shapes(f"ls.{tag}", tree, ps, sizes))
        for seq in (False, True) if seq_sharded_kv else (False,):
            cs = _pspecs(lambda ctx: j_steps.cache_shardings(caches, ctx), shape, seq)
            out.update(_local_shapes(f"lc.{tag}.{int(seq)}", caches, cs, sizes))
    np.savez(os.path.join(work, f"{name}.npz"), **out)
    return {"name": name, "arch": arch, "overrides": overrides, "grad_compress": grad_compress,
            "seq_sharded_kv": seq_sharded_kv, "routed": len(routed)}


def j_model_spec(jc):
    from repro.models import model as j_model

    return j_model.model_spec(jc)


def run_each(tmp_path, runs: list, timeout: float = 300) -> None:
    """Write each case's reference (``runs``: (``write_case`` keywords with
    ``arch``, mesh)), then run each case on its own mesh, the meshes'
    groups at once."""
    work = str(tmp_path / "data")
    os.makedirs(work, exist_ok=True)
    specs = []
    for i, (case, shape) in enumerate(runs):
        entry = write_case(work, meshes=[shape], **case)
        specs.append(("lm", {"mesh": list(shape), "axes": list(AXES[len(shape)]),
                             "cases": [entry], "data": work},
                      str(tmp_path / f"group{i}")))
    mesh_worker.spawn_all(specs, timeout=timeout)


def run(tmp_path, cases: list, meshes: list, timeout: float = 300) -> None:
    """Write each case's reference (``cases``: ``write_case`` keywords with
    ``arch``), then run them all on each mesh, one group of ranks a mesh,
    the meshes' groups at once."""
    work = str(tmp_path / "data")
    os.makedirs(work, exist_ok=True)
    entries = [write_case(work, meshes=meshes, **c) for c in cases]
    mesh_worker.spawn_all([("lm", {"mesh": list(shape), "axes": list(AXES[len(shape)]),
                                   "cases": entries, "data": work},
                            str(tmp_path / ("group" + "x".join(map(str, shape)))))
                           for shape in meshes], timeout=timeout)
