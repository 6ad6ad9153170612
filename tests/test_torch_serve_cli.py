"""The port's serving CLI (``python -m repro_torch.launch.serve``) held
against the reference's (``python -m repro.launch.serve``) in
subprocesses, on the CPU (``--device cpu``, ``REPRO_FLEET_TILE=64``).

The two banks draw their codebooks from different generators (torch's and
``jax.random``'s), so what must agree is what does not depend on the
codebooks: every line the reference prints has a line of the same format
in the port's output, in the same order (numbers aside); the decision
counts, the channel monitor's events (a function of the codes, drawn from
the same seeded numpy generator) and the compiled-step count are equal.

Tolerance: exact equality of those lines and counts.
"""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src", REPRO_FLEET_TILE="64", JAX_PLATFORMS="cpu")
SERVE = ["--hdc-fleet", "--sessions", "8", "--patients", "2", "--chunk", "64"]


def _run(module: str, args: list, timeout: int = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *args], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def _shape(line: str) -> str:
    """A line's format: its numbers masked."""
    return re.sub(r"-?\d+(\.\d+)?", "#", line.strip())


def _lines(out: str, prefix: str) -> list:
    return [ln.strip() for ln in out.splitlines() if ln.strip().startswith(prefix)]


def test_fleet_cli_matches_the_reference_lines_and_counts():
    flags = [*SERVE, "--rounds", "3", "--adapt-every", "2", "--channel-health",
             "--inject-fault", "3:dead"]
    port = _run("repro_torch.launch.serve", [*flags, "--device", "cpu"])
    ref = _run("repro.launch.serve", flags)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    got = [ln for ln in port.stdout.splitlines() if ln.strip()]
    want = [ln for ln in ref.stdout.splitlines() if ln.strip()]
    it = iter(got)
    for line in want:  # every reference line, in order, in the port's format
        assert any(_shape(g) == _shape(line) for g in it), line
    for prefix in ("  round ", "channel health:", "compiled step executables:",
                   "injected "):
        assert _lines(port.stdout, prefix) == _lines(ref.stdout, prefix), prefix
    decisions = [re.search(r"(\d+) decisions", _lines(o, "stream:")[0]).group(1)
                 for o in (port.stdout, ref.stdout)]
    # 64 cycles a round after a first push of 64: one frame a session, in round 3
    assert decisions[0] == decisions[1] == "8"
    assert _lines(port.stdout, "channel health:") == [
        "channel health: 8 channel(s) quarantined across the fleet (8 events)"]
    assert "kernel library: 0 nvcc build(s)" in _lines(port.stdout, "first decision:")[0]


def test_fleet_cli_warms_from_a_missing_artifact_with_a_warning(tmp_path):
    """On the CPU there is nothing to warm; an unreadable artifact warns and
    the stream runs as without one (the reference's line format)."""
    out = _run("repro_torch.launch.serve", [*SERVE, "--rounds", "1", "--device", "cpu",
                                            "--aot-dir", str(tmp_path / "none")])
    assert out.returncode == 0, out.stderr
    (line,) = _lines(out.stdout, "warmup from")
    assert re.fullmatch(r"warmup from \S+: 0 loaded, 0 compiled in \d+\.\d\d s"
                        r"  \[stale artifact: built from sources\]", line)
    assert "unreadable manifest" in out.stderr


def test_sigterm_drains_to_a_resumable_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE, "--device", "cpu",
         "--rounds", "100000", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if proc.poll() is not None:
                pytest.fail("serve exited early:\n" + proc.communicate()[0])
            if os.path.isdir(ckpt_dir) and any(
                    d.startswith("step_") and not d.endswith(".tmp")
                    for d in os.listdir(ckpt_dir)):
                break
            time.sleep(0.1)
        else:
            pytest.fail("serve did not reach its first checkpoint in 120 s")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    (caught,) = _lines(out, "caught SIGTERM")
    assert re.fullmatch(r"caught SIGTERM: checkpointed after round \d+, exiting 0", caught)
    rounds = int(caught.split("round ")[1].split(",")[0])
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    assert steps and not any(d.endswith(".tmp") for d in steps)
    resumed = _run("repro_torch.launch.serve", [*SERVE, "--device", "cpu", "--rounds", "1",
                                                "--ckpt-dir", ckpt_dir, "--resume"])
    assert resumed.returncode == 0, resumed.stderr
    (line,) = _lines(resumed.stdout, "resumed fleet from")
    # the first push and every round add 64 cycles to each of 8 sessions
    frames = int(re.search(r"frames so far: (\d+)", line).group(1))
    assert frames == 8 * ((1 + rounds) * 64 // 256)
    assert line.startswith(f"resumed fleet from {ckpt_dir} step {len(steps) - 1} ")


def test_compile_on_the_cpu_exits_with_its_message(tmp_path):
    art = tmp_path / "aot"
    out = _run("repro_torch.launch.serve", ["compile", "--aot-dir", str(art),
                                            "--device", "cpu", "--sessions", "4",
                                            "--patients", "1"])
    assert out.returncode == 1
    assert "CPU fleet (--device cpu) has none: no artifact written" in out.stderr
    assert not art.exists()
    out = _run("repro_torch.launch.serve", ["compile", "--device", "cpu"])
    assert out.returncode == 1 and "needs --aot-dir" in out.stderr
