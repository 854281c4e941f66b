"""Rank bodies that ``tests/test_torch_mesh.py`` spawns, one process a
mesh position.  Kept apart from the test module so the ranks import
torch and the port only, not JAX."""

import datetime
import os

import torch
import torch.distributed as dist


def grid_rank(rank: int, world: int, work: str, sync: str,
              sync_dtype: str) -> None:
    """Join a gloo group (a file store in ``work``), build the 2 x 2
    ``("data", "model")`` mesh, run `make_mesh_shard_fn` on this rank's
    documents and topic columns of ``work/inputs.pt`` (one mini-batch per
    entry, the same injected init on every rank), and save what came out
    to ``work/rank<r>.pt``."""
    from repro_torch.core import pobp
    from repro_torch.core.types import LDAConfig
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"))
        cfg = LDAConfig(**inp["cfg"])
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        d, m = mesh.get_coordinate()
        Kl = cfg.num_topics // 2
        local, meter = pobp.make_mesh_shard_fn(cfg, mesh, sync, sync_dtype)
        phi = inp["phi"][:, m * Kl:(m + 1) * Kl].contiguous()
        out = []
        for wid, cnt, u0 in inp["batches"]:
            phi, iters, mean_r = local(wid[d], cnt[d], phi, 1.0, u0=u0)
            out.append((phi.clone(), iters, float(mean_r)))
        torch.save({"coord": (d, m), "out": out,
                    "bytes": meter.bytes_by_phase,
                    "per_minibatch": [meter.per_minibatch_bytes(i)
                                      for i in (1, 4)]},
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
