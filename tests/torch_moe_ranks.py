"""Rank bodies that ``tests/test_torch_moe_ep.py`` spawns, one process a
mesh position.  Kept apart from the test module so the ranks import torch
and the port only, not JAX."""

import datetime
import os

import torch
import torch.distributed as dist


def island_rank(rank: int, world: int, work: str, shape) -> None:
    """Join a gloo group (a file store in ``work``), build the ``shape``
    ``("data", "model")`` mesh, run every case of ``work/inputs.pt``
    through ``moe_apply`` (and every ``lm`` case through ``lm.forward``)
    with an active ``ShardingCtx`` on it, and save the outputs to
    ``work/rank<r>.pt``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe
    from repro_torch.models.common import ShardingCtx

    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"))
        mesh = make_mesh(tuple(shape), ("data", "model"), "cpu")
        ctx = ShardingCtx(active=True, batch=("data",), model="model",
                          mesh=mesh)
        out = {"coord": tuple(mesh.get_coordinate())}
        for name, case in inp.get("moe", {}).items():
            cfg = get_config(case["arch"]).reduced()
            out[name] = moe.moe_apply(case["p"], case["x"], cfg=cfg, ctx=ctx)
        for name, case in inp.get("lm", {}).items():
            cfg = get_config(case["arch"]).reduced()
            out[name] = lm.forward(case["params"], case["tokens"], cfg, ctx,
                                   mode="prefill")[0]
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
