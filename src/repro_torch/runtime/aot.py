"""Deploy artifacts: the built kernel library, versioned, for warm restarts
(port of ``repro.runtime.aot``).

A restarted or autoscaled worker of the reference pays trace and XLA
compile for every bucket shape before its first decision; the reference
ships serialized executables to skip that.  The port compiles nothing at
run time but its CUDA kernel library, and that ``nvcc`` build (seconds a
source) is the cold-start tax a fresh checkout pays.  An artifact carries:

* ``manifest.json``: the format version, the validity key
  (``artifact_key``) and the entry names of the fleet or engine that wrote
  it (``AOTEntry``: one step a tile shape and bucket, an adapt step a tile
  shape, an engine dispatch a batch bucket);
* a copy of the built kernel library, which ``load_library`` hands to
  ``kernels/build.py`` (no ``nvcc``).

CUDA graphs are not shipped: a graph holds the addresses of one process's
tensors, so a worker captures its graphs at warm-up
(``StreamingFleet.warmup``); an entry named in a valid artifact counts as
"loaded", one captured without it as "compiled".

The key pins an artifact to the torch and CUDA versions, the card's name
and compute capability, and the digest of the kernel sources and nvcc
flags (``kernel_fingerprint``).  ``load_artifact`` returns ``None`` with a
warning for an unreadable or stale artifact, and the caller builds from
``csrc/`` as usual: an artifact is a start-up optimisation, never a
correctness dependency.  A library that fails to load from a valid
artifact raises.

The reference's persistent compilation cache (``enable_compilation_cache``,
``compilation_cache``) and its StableHLO tier have no counterpart: nothing
in the port is compiled per shape.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build

MANIFEST = "manifest.json"
ARTIFACT_VERSION = 1
KINDS = ("step", "adapt", "engine")


def kernel_fingerprint(csrc: str | Path | None = None) -> str:
    """Digest of the kernel sources (every file of ``csrc``, default the
    package's ``kernels/csrc``) and the nvcc flags: the digest that names
    the built library.  An edited source invalidates every artifact."""
    return build.digest(Path(csrc) if csrc is not None else build.CSRC)


def device_kind(device=None) -> str:
    """``cuda:<card name>`` for a CUDA device (``None`` = the card; raises
    without one), ``cpu`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def artifact_key(*, device=None) -> dict:
    """What an artifact is only valid under: the format version, the torch
    and CUDA versions, the device's name and compute capability, and the
    kernel sources' digest."""
    dev = resolve_device(device)
    cap = (".".join(map(str, torch.cuda.get_device_capability(dev)))
           if dev.type == "cuda" else None)
    return {
        "format": ARTIFACT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device_kind(dev),
        "capability": cap,
        "kernels": kernel_fingerprint(),
    }


def stale_fields(saved: dict, current: dict) -> dict:
    """``{field: (saved, current)}`` for every key field that disagrees;
    empty means the artifact is valid here."""
    return {k: (saved.get(k), current[k]) for k in current
            if saved.get(k) != current[k]}


@dataclass(frozen=True)
class AOTEntry:
    """One program a worker warms: a fleet step of one tile shape and
    bucket (``step``), a fleet adapt of one tile shape (``adapt``) or an
    engine dispatch of one batch bucket (``engine``; ``tile`` the padded
    batch, ``bucket`` the request length)."""

    name: str
    kind: str
    tile: int
    bucket: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"AOT entry kind {self.kind!r} not in {KINDS}")


def save_artifact(path: str, entries, *, key: dict | None = None) -> dict:
    """Write a deploy artifact at ``path``: the manifest (format, key,
    entries) and a copy of the kernel library ``build.build()`` gives.
    Written into ``<path>.tmp`` and renamed, as checkpoints are, so a
    reader never sees half an artifact.  Returns the manifest."""
    names = [e.name for e in entries]
    dup = sorted({n for n in names if names.count(n) > 1})
    if dup:
        raise ValueError(f"duplicate AOT entry names {dup}")
    lib_src = build.build()
    manifest = {
        "version": ARTIFACT_VERSION,
        "key": key if key is not None else artifact_key(),
        "library": lib_src.name,
        "entries": [{"name": e.name, "kind": e.kind, "tile": e.tile,
                     "bucket": e.bucket} for e in entries],
    }
    final = os.path.abspath(path)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shutil.copy2(lib_src, os.path.join(tmp, lib_src.name))
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return manifest


class AOTArtifact:
    """A loaded, key-validated deploy artifact."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest
        self._names = {e["name"] for e in manifest["entries"]}

    @property
    def key(self) -> dict:
        return self.manifest["key"]

    @property
    def names(self) -> list[str]:
        return [e["name"] for e in self.manifest["entries"]]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    @property
    def library(self) -> Path:
        """The path of the artifact's copy of the kernel library."""
        return Path(self.path) / self.manifest["library"]


def load_library(art: AOTArtifact | None) -> None:
    """Load the kernel library unless one is loaded: the artifact's copy
    (no ``nvcc``; raises when it does not load), or without an artifact
    the usual build from ``csrc/``."""
    build.lib(path=None if art is None else art.library)


def load_artifact(path: str, *, expected_key: dict | None = None,
                  device=None) -> AOTArtifact | None:
    """Read and key-check an artifact; ``None`` with a warning when the
    manifest is unreadable or the key is stale (different torch or CUDA,
    card or kernel sources), so the caller builds from ``csrc/``.
    ``expected_key`` defaults to ``artifact_key(device=device)``."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        warnings.warn(f"AOT artifact {path!r}: unreadable manifest "
                      f"({type(ex).__name__}: {ex}); building from sources",
                      stacklevel=2)
        return None
    current = expected_key if expected_key is not None else artifact_key(device=device)
    bad = stale_fields(manifest.get("key", {}), current)
    if bad:
        warnings.warn(
            f"AOT artifact {path!r} is stale: "
            + ", ".join(f"{k}: saved {s!r} != current {c!r}"
                        for k, (s, c) in sorted(bad.items()))
            + "; building from sources", stacklevel=2)
        return None
    return AOTArtifact(path, manifest)
