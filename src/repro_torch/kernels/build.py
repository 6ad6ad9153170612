"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object (one process per source, all started together), then linked into
one shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by the sources'
digest, so a changed source is rebuilt and an unchanged one is reused.
``lib(path=...)`` loads a library shipped in a deploy artifact
(``runtime/aot.py``) instead, with no ``nvcc``.  ``BUILD_LOG`` and
``LOAD_LOG`` list every build and every load of this process, for warm-up
reports and ``analysis/guards.py``.

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signature of every exported launcher: (argtypes); all return cudaError_t
SIGNATURES = {
    "lbp_codes_launch": [_P, _P, _L, _L, _L, _I, _P],
    "hdc_encoder_launch": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                           _L, _L, _P, _P, _P, _I, _P, _P],
    "hdc_am_launch": [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    "hdc_fleet_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    "dense_hdc_launch": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _L, _L, _P, _P,
                         _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None
# the libraries this process compiled with nvcc, and the ones it loaded
BUILD_LOG: list[str] = []
LOAD_LOG: list[str] = []


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest(csrc: Path = CSRC) -> str:
    """16 hex digits of sha256 over every file of ``csrc`` (name and bytes)
    and the nvcc flags: the name of the library they build."""
    h = hashlib.sha256()
    for p in sorted(Path(csrc).iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile the kernels (if the digest-named library is missing) and
    return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libhdc_kernels_{digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    BUILD_LOG.append(str(lib_path))
    return lib_path


def lib(path: str | Path | None = None) -> ctypes.CDLL:
    """The loaded kernel library: on first call loaded from ``path`` (a
    deploy artifact's copy, no ``nvcc``) or else built from ``csrc/``.
    Once a library is loaded, later calls return it whatever ``path`` says
    (an artifact is only used when its key names these sources).  A library
    that does not load raises."""
    global _lib
    if _lib is None:
        where = Path(path) if path is not None else build()
        try:
            handle = ctypes.CDLL(str(where))
        except OSError as ex:
            raise RuntimeError(f"kernel library {where} does not load: {ex}") from ex
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.hdc_error_string.argtypes = [ctypes.c_int]
        handle.hdc_error_string.restype = ctypes.c_char_p
        _lib = handle
        LOAD_LOG.append(str(where))
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        what = lib().hdc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({what})")


def stream_ptr(tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the tensor's
    device (named by its index: no ``torch.device`` to parse)."""
    return torch.cuda.current_stream(tensor.get_device()).cuda_stream
