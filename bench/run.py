"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up's parts are printed as they end;
the last line of standard output is the result as one JSON object; the
numbers compared with the plain reference, each beside its limit, are the
last lines of standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it exits with 2 and prints no result.  It builds
the port's kernels into ``build/kernels/`` of the checkout (the first run
there) and keeps every other cache under ``build/`` too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder is not a place to import from: its modules are
# imported as ``bench.*`` from the root
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _fail(msg: str, code: int = 2) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    parts = {}
    t = time.perf_counter()
    import torch

    from bench import harness
    import repro_torch.core.pipeline  # noqa: F401
    import repro_torch.kernels.lbp.ops  # noqa: F401
    parts["imports"] = time.perf_counter() - t
    print(f"setup: imports {parts['imports']:.3f} s", flush=True)

    if not torch.cuda.is_available():
        _fail("no CUDA device is available; the benchmark runs only on the card")
    bench = harness.load_benchmark(ROOT)
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        _fail(f"unknown workload {args.workload!r}")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} present")

    t = time.perf_counter()
    torch.cuda.init()
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")
    parts["cuda_init"] = time.perf_counter() - t
    print(f"setup: cuda_init {parts['cuda_init']:.3f} s", flush=True)
    t = time.perf_counter()
    from repro_torch.kernels import build
    build.lib()
    parts["kernel_load"] = time.perf_counter() - t
    print(f"setup: kernel_load {parts['kernel_load']:.3f} s"
          f" ({'built' if build.BUILD_LOG else 'loaded'} {build.LOAD_LOG[-1]})", flush=True)
    torch.set_num_threads(2)

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t0=T0, setup_parts=parts)
    # the window has closed: nothing of JAX or the JAX package may be loaded
    found = harness.forbidden_modules()
    if found:
        _fail("modules of JAX or the JAX package are loaded: " + ", ".join(found), 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
