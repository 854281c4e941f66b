"""Rank bodies that ``tests/test_torch_serve_mesh.py`` spawns, one process
a mesh position.  Kept apart from the test module so the ranks import
torch and the port only, not JAX.

Each rank joins a gloo group (a file store in ``work``), builds the
``("data", "model")`` mesh of the given shape on the CPU, serves the
cases of ``work/inputs.pt`` through the engines placed on it, and saves
what came out to ``work/rank<r>.pt``."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def _served(results):
    """{req_id: (theta, iters, bucket, mean_r, comm_bytes, oov, version)}."""
    return {r.req_id: (r.theta.copy(), r.iters, r.bucket, r.mean_r,
                       r.comm_bytes, r.oov_tokens, r.phi_version)
            for r in results}


def _serve(engine, docs):
    for d in docs:
        engine.submit(d)
    return _served(engine.drain())


def _replay(engine, draws, key: str, cut_l: bool = False) -> None:
    """Feed ``engine``'s step the injected init draws, one a call
    (``init_u`` for the slab, ``mu0`` cut to the batch's L for the
    bucket engine); running out of draws raises."""
    step, it = engine._step, iter(draws)

    def replayed(*args, **kw):
        u = next(it)
        kw[key] = u[:, :args[1].shape[1]] if cut_l else u
        return step(*args, **kw)

    engine._step = replayed


def _held_tensors(engine):
    """Every tensor an engine holds, its slab state's included."""
    out = [v for v in vars(engine).values() if isinstance(v, torch.Tensor)]
    state = getattr(engine, "_state", None)
    if state is not None:
        out += [v for v in vars(state).values()
                if isinstance(v, torch.Tensor)]
    return out


def _phi_like(engine):
    """(phi's shape, the shapes of every held tensor with phi's W' rows)."""
    rows = engine._phi.shape[-2]
    return (tuple(engine._phi.shape),
            [tuple(t.shape) for t in _held_tensors(engine)
             if t.dim() >= 2 and rows in t.shape])


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _placed_blocks(mesh, arr):
    """``dist.checkpoint._placed`` against ``distribute_tensor`` for a few
    specs: (local blocks equal, local holds only its block, global shape)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist.sharding import P, placements

    out = {}
    for spec in (P(None, "model"), P("model", None), P("data", "model"),
                 P("data", None), P(None, None), P(("data", "model"), None)):
        got = ckpt._placed(arr, (mesh, spec))
        want = distribute_tensor(arr, mesh, placements(spec, mesh),
                                 src_data_rank=None)
        local = got.to_local()
        out[str(spec)] = (
            torch.equal(local, want.to_local()),
            local.untyped_storage().nbytes()
            == local.numel() * local.element_size(),
            tuple(got.shape), [str(p) for p in got.placements])
    return out


def _one_process_cases(inp, mesh, spec):
    """A mesh whose ``model`` axis has one rank: the placed engines
    against the unplaced ones, each served the same requests."""
    from repro_torch.serve import FoldInEngine, SlabEngine

    out = {}
    for name, cls, kw in (("slab", SlabEngine, inp["slab_kw"]),
                          ("bucket", FoldInEngine, inp["bucket_kw"])):
        placed = cls.from_checkpoint(inp["ckpt"], sharding=(mesh, spec),
                                     device="cpu", **kw)
        plain = cls.from_checkpoint(inp["ckpt"], device="cpu", **kw)
        out[name] = (_serve(placed, inp["docs"]), _serve(plain, inp["docs"]),
                     placed._place.group is None,
                     tuple(placed._phi.shape), tuple(plain._phi.shape),
                     placed.stats()["bytes_by_phase"])
    return out


def _two_rank_cases(inp, mesh, spec, rank):
    """The cases of a ``model`` axis of two ranks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.types import LDAConfig
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import FoldInEngine, SlabEngine

    out = {}
    placed = (mesh, spec)
    docs = inp["docs"]

    # the reference's topic_shards=2 slab, its draws replayed
    eng = SlabEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                     device="cpu", **inp["slab_kw"])
    _replay(eng, inp["slab_draws"], "init_u")
    out["slab_ref"] = (_serve(eng, docs), eng.stats())
    out["resident_slab"] = _phi_like(eng)

    # the reference's topic_shards=2 bucket engine, its draws replayed;
    # then seeded, against the port's one-process engine
    eng = FoldInEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                       device="cpu", warmup=False,
                                       **inp["bucket_kw"])
    _replay(eng, inp["bucket_draws"], "mu0", cut_l=True)
    out["bucket_ref"] = (_serve(eng, docs), eng.stats())
    eng = FoldInEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                       device="cpu", **inp["bucket_kw"])
    out["bucket_seeded"] = (_serve(eng, docs), eng.stats(),
                            eng.theta_gather_bytes)
    out["resident_bucket"] = _phi_like(eng)
    # flush_stale takes the oldest age maxed over the ranks: rank 0 sees
    # the queue stale, rank 1 not, and both dispatch the same batches
    for d in docs[:3]:
        eng.submit(d)
    ages = [t for q in eng._queues.values() for _, _, t, _ in q]
    now = max(ages) + (100.0 if rank == 0 else 0.0)
    out["flush_stale"] = (eng.flush_stale(50.0, now=now),
                          _served(eng.drain()))

    # four shards, two a rank; three do not split over two ranks
    eng = SlabEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                     device="cpu", topic_shards=4,
                                     **inp["slab_kw"])
    out["shards4"] = (_serve(eng, docs), eng.stats()["bytes_by_phase"],
                      tuple(eng._phi.shape))
    out["shards3"] = _error(lambda: SlabEngine.from_checkpoint(
        inp["ckpt"], sharding=placed, device="cpu", topic_shards=3,
        **inp["slab_kw"]))

    # a dynamic-vocabulary checkpoint: vocab table, live rows, guard rows
    eng = SlabEngine.from_checkpoint(inp["dyn_ckpt"], sharding=placed,
                                     device="cpu", **inp["slab_kw"])
    out["dyn"] = (_serve(eng, inp["dyn_docs"]), eng.stats())

    # an already-normalized phi with guard rows (1/K of the global K)
    norm, _, _ = ckpt.restore_phi(inp["norm_ckpt"], sharding=placed)
    cfg = LDAConfig(vocab_size=norm.shape[0], num_topics=norm.shape[1])
    eng = SlabEngine(norm, cfg, normalized=True,
                     live_words=inp["norm_live"], device="cpu",
                     **inp["slab_kw"])
    out["normalized"] = (_serve(eng, docs), eng._phi[:, -1].clone())

    # swaps: a DTensor placed as the engine's phi, then a whole statistic
    eng = SlabEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                     device="cpu", **inp["slab_kw"])
    swapped = [_serve(eng, docs[:6])]
    phi2, _, _ = ckpt.restore_phi(inp["ckpt2"], sharding=placed)
    eng.swap_phi(phi2)
    swapped.append(_serve(eng, docs[6:12]))
    eng.swap_phi(inp["phi3"])
    swapped.append(_serve(eng, docs[12:18]))
    out["swap"] = (swapped, tuple(eng._phi.shape))
    beng = FoldInEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                        device="cpu", **inp["bucket_kw"])
    beng.swap_phi(inp["phi3"])
    out["bucket_swap"] = _serve(beng, docs[:8])
    whole, _, _ = ckpt.restore_phi(inp["ckpt"], sharding=(mesh, P(None,
                                                                  None)))
    out["swap_other_placement"] = _error(lambda: eng.swap_phi(whole))
    rows, _, _ = ckpt.restore_phi(inp["ckpt"], sharding=(mesh, P("model",
                                                                 None)))

    # placements that would gather phi whole, and a mesh with no model axis
    out["rows_placed"] = _error(lambda: SlabEngine(
        rows, inp["cfg"], device="cpu", **inp["slab_kw"]))
    topics = make_mesh((1, 2), ("data", "topics"), "cpu")
    phi_t, _, _ = ckpt.restore_phi(inp["ckpt"],
                                   sharding=(topics, P(None, "topics")))
    out["no_model_axis"] = _error(lambda: SlabEngine(
        phi_t, inp["cfg"], device="cpu", **inp["slab_kw"]))
    out["is_dtensor"] = isinstance(phi_t, DTensor)

    # with admission shedding, each step's wall time is agreed
    eng = SlabEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                     device="cpu", admission_slo_s=60.0,
                                     **inp["slab_kw"])
    out["slo"] = (_serve(eng, docs), eng.stats()["step_ema_s"])

    # a collective that fails raises; nothing serves on without it
    eng = SlabEngine.from_checkpoint(inp["ckpt"], sharding=placed,
                                     device="cpu", **inp["slab_kw"])
    real = dist.all_reduce

    def broken(*args, **kw):
        raise RuntimeError("all_reduce refused")

    dist.all_reduce = broken
    try:
        out["broken_collective"] = _error(lambda: _serve(eng, docs[:4]))
    finally:
        dist.all_reduce = real
    return out


def serve_rank(rank: int, world: int, work: str, shape) -> None:
    from repro_torch.dist.sharding import phi_serving_spec
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.set_num_threads(1)
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        mesh = make_mesh(tuple(shape), ("data", "model"), "cpu")
        spec = phi_serving_spec(mesh, np.empty(inp["shape"]))
        out = {"coord": tuple(mesh.get_coordinate()), "spec": list(spec),
               "placed": _placed_blocks(mesh, inp["phi_acc"])}
        if shape[1] == 1:
            out.update(_one_process_cases(inp, mesh, spec))
        else:
            out.update(_two_rank_cases(inp, mesh, spec, rank))
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
