"""Device meshes over a ``torch.distributed`` process group (port of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group, one rank a device, with named axes:

  single-pod  (data=16, model=16)            = 256 cards
  multi-pod   (pod=2, data=16, model=16)     = 512 cards

The group comes from the launcher: ``python -m torch.distributed.run
--nproc-per-node N ...`` sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and the
rendezvous, and ``make_mesh`` joins it through ``env://``.  A process that
was not launched so gets a group of one rank over a ``FileStore`` in a
fresh temporary directory, as ``jax.make_mesh((1,), ...)`` works in one
process.  A group the caller initialised already is used as it is.

Backends: ``gloo`` on the CPU; on the card ``cpu:gloo,cuda:nccl``, so that
the host-side gathers of the serving fleet (CPU tensors) need no device
collective.  Each rank sits on ``cuda:{LOCAL_RANK}`` unless ``device``
names another card.  Nothing falls back: a mesh larger (or smaller) than
the world raises, and so does a CUDA mesh without a card.

Functions, not module constants: importing this module starts no process
group.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

# seconds a collective may wait for a peer before the rank fails: a rank
# that died or hung fails its peers instead of holding them forever
DEFAULT_TIMEOUT_S = 300.0


def fake_world(n: int) -> None:
    """Start the ``"fake"`` process group as rank 0 of ``n`` ranks (256 or
    512 for the production meshes): the counterpart of the reference's
    placeholder devices (``XLA_FLAGS`` before jax is imported, guarded by
    ``host_device_count_or_die``).  Its collectives move nothing and return
    at once, so one process traces one rank's step (``launch/dryrun.py``,
    on fake tensors); ``make_mesh`` then builds its mesh over it.  A fake
    group of ``n`` ranks already started is used as it is; a real process
    group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a fake world cannot start inside a real process group "
                f"({dist.get_backend()!r}, {dist.get_world_size()} ranks)")
        if dist.get_world_size() != n:
            raise RuntimeError(f"the fake world has {dist.get_world_size()} ranks, "
                               f"not {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def is_fake_world() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, timeout_s=timeout_s)


def device_count_or_die(n: int) -> None:
    """Raise unless the process group holds at least ``n`` ranks."""
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh needs {n} ranks but the process group has {have}; start "
            f"one process a device with `python -m torch.distributed.run "
            f"--nproc-per-node {n} ...`")


def _init_group(dev: torch.device, timeout_s: float) -> None:
    """Join the launcher's group (``env://``), or make a group of one rank
    over a ``FileStore``."""
    backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timeout)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None, *,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the world's ranks in
    row-major order (rank r at ``divmod``-coordinates of r).  ``device``:
    this rank's device (``None``: ``cuda:{LOCAL_RANK}``, raising without a
    card; ``"cpu"``: a CPU mesh).  ``timeout_s`` bounds every collective of
    a group this call creates."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                               "device='cpu' for a CPU mesh")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        _init_group(dev, timeout_s)
    n = math.prod(shape)
    device_count_or_die(n)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"mesh {shape} has {n} ranks but the process group has {world}: "
            "a mesh covers the whole world")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
