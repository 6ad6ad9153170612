"""The dry-run on the production meshes' fake worlds (``launch/mesh.py``
``fake_world``, 256 and 512 ranks): a reduced qwen3-0.6b cell on (16, 16)
and on (2, 16, 16), and a 24-head config on (16, 16), whose 24 query and 8
KV heads the 16 ``model`` ranks divide neither (every projection and the
output product replicated over ``model``), trace only.
"""

import pytest
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.data import lm as lmdata
from repro_torch.launch import dryrun

OVERRIDES = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, vocab=1024, d_ff=512)


@pytest.mark.parametrize("kind,step", [("single", "train"), ("multi", "prefill")])
def test_reduced_cell_on_production_mesh(kind, step):
    """The cell traces as one rank (4 query and 2 KV heads over 16 ``model``
    ranks) and counts its work, its collectives and its arguments."""
    cfg = registry.get_config("qwen3-0.6b").reduced(**OVERRIDES)
    shape = lmdata.ShapeSpec(step, 64, 32, step)
    try:
        mesh = dryrun.production_mesh(kind)
        assert tuple(mesh.shape) == ((16, 16) if kind == "single" else (2, 16, 16))
        r = dryrun.trace_cell(cfg, shape, mesh)
        assert r["cost"]["flops"] > 0 and r["collectives"]["n_ops"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0
        if kind == "single":   # 24 query and 8 KV heads over 16 ranks
            wide = registry.get_config("llama3.2-3b").reduced(
                n_layers=1, d_model=384, n_heads=24, n_kv_heads=8, head_dim=16,
                vocab=512, d_ff=512)
            for kind_ in ("train", "decode"):     # train runs prefill's forward
                dryrun.trace_cell(wide, lmdata.ShapeSpec(kind_, 32, 16, kind_), mesh)
    finally:
        dist.destroy_process_group()


