"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: fault-tolerant resume, its flags, and a checkpoint carried over
from the reference's launcher.

* Straight against ``--fail-at 5`` with ``--ckpt-every 2``: the second run
  restarts once, restores step 4 and ends at the straight run's
  ``final_loss`` within 1e-5 (the reference's own bar,
  ``tests/test_runtime.py``); every step's printed loss equal.
* ``--grad-compress`` with ``--opt-dtype bfloat16``: runs, checkpoints the
  bf16 moments as raw 16-bit words and resumes from them.
* ``--mesh 1x2`` on 2 ranks, then ``--mesh 2x1`` from its step-4
  checkpoint, ends at an unsharded run's loss within 1e-5; ``--fresh``
  drops the directory's old checkpoints.
* A checkpoint written by the reference's ``launch/train.py`` restores
  into the port (``ckpt.restore``): the same values, and the port's next
  step from the reference's next batch equals the reference's next step
  (loss ``rtol=1e-5``, each parameter within 1e-2 of its largest update,
  the bound of ``test_torch_lm_train.py``).
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_ckpt
from repro.configs import registry as j_registry
from repro.data import lm as j_lm
from repro.launch import train as j_train
from repro.models import model as j_model
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro.runtime.sharding import make_ctx
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import params
from repro_torch.models.model import model_spec
from repro_torch.optim import adamw
from repro_torch.runtime import steps

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
        "--seq", "32"]


def _run(args: list) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _final_loss(out: str) -> float:
    lines = [ln for ln in out.splitlines() if ln.startswith("done: final_loss=")]
    assert len(lines) == 1, out
    return float(lines[0].split("=")[1].split()[0])


def _step_losses(out: str) -> dict:
    return {int(ln.split()[1]): ln.split()[3] for ln in out.splitlines()
            if ln.startswith("step ")}


def test_fail_at_resumes_to_the_straight_runs_loss(tmp_path, capsys):
    """The straight run in this process (``main``), the failing one as the
    user runs it (``python -m``)."""
    base = BASE + ["--steps", "8", "--ckpt-every", "2", "--fresh"]
    train.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    straight = capsys.readouterr().out
    failed = _run(base + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "5"])
    assert "[watchdog] attempt 0 failed: injected failure at step 5" in failed
    assert "restarting from latest checkpoint" in failed
    assert f"[resume] restored step 4 from {tmp_path / 'b'}" in failed
    assert abs(_final_loss(straight) - _final_loss(failed)) < 1e-5
    assert _step_losses(straight) == _step_losses(failed)
    # the restarted attempt ran steps 4..7 only
    assert [ln.split()[1] for ln in failed.splitlines()[-5:-1]] == ["4", "5", "6", "7"]


def test_a_failed_attempts_checkpoint_lands_before_the_restart(tmp_path, capsys,
                                                               monkeypatch):
    """The step-4 checkpoint is still being written (a slow disk) when step
    5 fails: the restart waits for it and resumes from step 4, not 2."""
    import time

    write = ckpt._write

    def slow(*a, **k):
        time.sleep(0.5)
        write(*a, **k)

    monkeypatch.setattr(ckpt, "_write", slow)
    d = str(tmp_path)
    train.main(BASE + ["--steps", "6", "--ckpt-every", "2", "--fresh", "--ckpt-dir", d,
                       "--fail-at", "5"])
    out = capsys.readouterr().out
    assert f"[resume] restored step 4 from {d}" in out
    assert ckpt.list_steps(d) == [2, 4, 6]


def _args(argv: list) -> argparse.Namespace:
    return train.parser().parse_args(argv)


def test_grad_compress_with_bf16_state_runs_and_resumes(tmp_path):
    d = str(tmp_path)
    out = train.train_loop(_args(BASE + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", d,
                                         "--fresh", "--grad-compress",
                                         "--opt-dtype", "bfloat16"]))
    assert out["steps"] == 4 and np.isfinite(out["losses"]).all()
    like = {"m": {"embed": torch.zeros((256, 64), dtype=torch.bfloat16)}}
    got = ckpt.restore(d, 4, like)["m"]["embed"]
    assert got.dtype == torch.bfloat16 and got.abs().sum() > 0
    again = train.train_loop(_args(BASE + ["--steps", "6", "--ckpt-every", "2", "--ckpt-dir",
                                           d, "--grad-compress", "--opt-dtype", "bfloat16"]))
    assert again["steps"] == 2 and np.isfinite(again["losses"]).all()


def test_fresh_discards_old_checkpoints(tmp_path):
    """``--fresh`` starts at step 0 and drops what the directory held, so
    a later resume cannot pick up an older run's higher step."""
    d = str(tmp_path)
    train.train_loop(_args(BASE + ["--steps", "6", "--ckpt-every", "2", "--ckpt-dir", d]))
    assert ckpt.list_steps(d) == [2, 4, 6]
    out = train.train_loop(_args(BASE + ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", d,
                                         "--fresh"]))
    assert out["steps"] == 2 and ckpt.list_steps(d) == [2]


def test_mesh_is_refused(tmp_path):
    """``--mesh`` (refused until the LM-on-a-mesh slice) trains elastically:
    ``--mesh 1x2 --fresh`` for 4 steps on 2 ranks, then ``--mesh 2x1`` to
    8 steps, restoring the 1x2 run's step-4 checkpoint onto the other mesh
    (the reference's ``tests/test_runtime.py::test_elastic_reshard_across_meshes``).
    The final loss equals, within 1e-5, an unsharded run of the same two
    invocations (4 steps, then resumed to 8: the schedule's ``total_steps``
    is each invocation's ``--steps``, as the reference's)."""
    def mesh_run(args: list) -> str:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
                           capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    base = BASE + ["--ckpt-every", "2"]
    sharded, plain = str(tmp_path / "mesh"), str(tmp_path / "plain")
    first = mesh_run(base + ["--steps", "4", "--fresh", "--mesh", "1x2", "--ckpt-dir", sharded])
    assert first.count("done: final_loss=") == 1               # rank 0 prints
    assert ckpt.list_steps(sharded) == [2, 4]
    second = mesh_run(base + ["--steps", "8", "--mesh", "2x1", "--ckpt-dir", sharded])
    assert f"[resume] restored step 4 from {sharded}" in second
    assert [ln.split()[1] for ln in second.splitlines() if ln.startswith("step ")] == \
        ["4", "5", "6", "7"]
    _run(base + ["--steps", "4", "--fresh", "--ckpt-dir", plain])
    straight = _run(base + ["--steps", "8", "--ckpt-dir", plain])
    assert abs(_final_loss(second) - _final_loss(straight)) < 1e-5


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    d = str(tmp_path)
    ref_args = argparse.Namespace(
        arch="qwen3-0.6b", reduced=True, steps=4, batch=2, seq=32, accum=1, mesh=None,
        seed=0, ckpt_dir=d, ckpt_every=2, log_every=1, opt_dtype="float32",
        grad_compress=False, fresh=True, step_timeout_s=3600.0, fail_at=None,
        max_restarts=0)
    j_train.train_loop(ref_args)
    assert j_ckpt.latest_step(d) == 4
    jc = j_registry.get_config("qwen3-0.6b").reduced()
    tc = registry.get_config("qwen3-0.6b").reduced()

    # the reference's state at step 2, restored by both packages
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), j_model.model_spec(jc))
    jopt = j_adamw.OptConfig(total_steps=4, warmup_steps=1)
    j_state = j_ckpt.restore(d, 2, {"params": jparams, "m": jparams, "v": jparams,
                                    "step": jnp.zeros((), jnp.int32)})
    zeros = params.tree_map(lambda s: torch.zeros(s.shape), model_spec(tc))
    t_state = ckpt.restore(d, 2, {"params": zeros, "m": params.tree_map(torch.clone, zeros),
                                  "v": params.tree_map(torch.clone, zeros),
                                  "step": torch.zeros((), dtype=torch.int32)})
    assert int(t_state["step"]) == 2
    for part in ("params", "m", "v"):
        want = params.flatten(jax.tree.map(np.asarray, j_state[part]))
        for k, v in params.flatten(t_state[part]).items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=f"{part} {k}")

    # the next step from the reference's batch for step 2
    shape = j_lm.ShapeSpec("train", 32, 2, "train")
    batch = jax.tree.map(np.asarray, j_lm.batch_for_step(jc, shape, 2))
    jstep = jax.jit(j_steps.make_train_step(jc, jopt, make_ctx(None)))
    jp, _, jl, _ = jstep(j_state["params"], {k: j_state[k] for k in ("m", "v", "step")}, batch)
    topt = adamw.OptConfig(total_steps=4, warmup_steps=1)
    tstate = {k: t_state[k] for k in ("m", "v", "step")}
    tp, _, tl, _ = steps.make_train_step(tc, topt)(
        t_state["params"], tstate, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    before = params.flatten(jax.tree.map(np.asarray, j_state["params"]))
    after = params.flatten(jax.tree.map(np.asarray, jp))
    for k, v in params.flatten(tp).items():
        update = np.abs(after[k] - before[k]).max()
        assert np.abs(v.numpy() - after[k]).max() <= 1e-2 * max(update, 1e-12), k


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    """The reference writes a bf16 leaf as raw 16-bit words (numpy void
    ``|V2``) and cannot read it back (ROADMAP queue 3); the port reads the
    same bits, and writes its own bf16 leaves the same way."""
    words = np.array([0x3F80, 0xC049, 0x0001, 0x7F7F], np.uint16)   # 1, -3.14, tiny, max
    leaf = jnp.asarray(words.view(jnp.bfloat16))
    j_ckpt.save(str(tmp_path / "ref"), 1, {"m": leaf})
    with pytest.raises(TypeError):
        j_ckpt.restore(str(tmp_path / "ref"), 1, {"m": jnp.zeros(4, jnp.bfloat16)})
    got = ckpt.restore(str(tmp_path / "ref"), 1, {"m": torch.zeros(4, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["m"].view(torch.int16).numpy().view(np.uint16), words)
    ckpt.save(str(tmp_path / "port"), 1, got)
    again = ckpt.restore(str(tmp_path / "port"), 1, {"m": torch.zeros(4, dtype=torch.bfloat16)})
    assert torch.equal(again["m"].view(torch.int16), got["m"].view(torch.int16))
    with open(tmp_path / "port" / "step_00000001" / "manifest.json") as f:
        assert '"dtype": "bfloat16"' in f.read()
