"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``; and an entry
point asked for the default device when no card is present raises instead
of carrying on on the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "jaxlib", "ml_dtypes")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    """Exact top-level match: ``repro_torch`` is allowed, ``repro`` and
    ``repro.x`` are not."""
    return module.split(".")[0] in FORBIDDEN


def test_port_and_chip_smoke_import_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 10
    hits = [(str(p.relative_to(ROOT)), m) for p in PORT_FILES
            for m in _imported_modules(p) if _forbidden(m)]
    assert hits == []


def test_forbidden_match_is_exact_not_prefix():
    assert _forbidden("repro") and _forbidden("repro.core.infer")
    assert _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core.infer")
    assert not _forbidden("jaxtyping")


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    from repro_torch.core import infer
    from repro_torch.core.types import LDAConfig, MiniBatch
    from repro_torch.serve import FoldInEngine, SlabEngine

    cfg = LDAConfig(vocab_size=20, num_topics=4)
    phi = np.ones((20, 4), np.float32)
    for build in (lambda: SlabEngine(phi, cfg, slots=2, slot_len=8),
                  lambda: FoldInEngine(phi, cfg, len_buckets=(8,)),
                  lambda: infer.make_slab_step(cfg, slots=2, slot_len=8),
                  lambda: infer.make_fold_in_step(cfg),
                  lambda: infer.fold_in_tokens(
                      MiniBatch(torch.zeros((1, 8), dtype=torch.int32),
                                torch.zeros((1, 8))),
                      torch.ones((20, 4)), cfg)):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    # an explicit CPU request runs
    SlabEngine(phi, cfg, slots=2, slot_len=8, device="cpu")


def test_training_entry_points_default_to_the_card(no_card):
    from repro_torch import convert
    from repro_torch.core import perplexity, pobp
    from repro_torch.core.types import LDAConfig, MiniBatch

    cfg = LDAConfig(vocab_size=20, num_topics=4)
    mb = MiniBatch(torch.zeros((1, 8), dtype=torch.int32), torch.ones((1, 8)))
    for build in (lambda: pobp.make_train_step(cfg),
                  lambda: pobp.init_train_state(cfg),
                  lambda: pobp.run_stream([mb], cfg),
                  lambda: perplexity.evaluate(torch.ones((20, 4)), mb, mb,
                                              cfg),
                  lambda: convert.train_state_from_reference(
                      np.ones((20, 4), np.float32), 0, seed=0)):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state, diag = step(pobp.init_train_state(cfg, device="cpu"),
                       mb.word_ids, mb.counts)
    assert state.m == 1 and diag["iters"] >= 1


def test_cli_default_device_raises_without_a_card(no_card, tmp_path):
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import serve as serve_mod

    ckpt.save(str(tmp_path), 1,
              {"state": {"phi_acc": np.ones((20, 4), np.float32)}},
              extra={"run": {"vocab": 20, "topics": 4}})
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.main(["--mode", "lda", "--ckpt-dir", str(tmp_path),
                        "--requests", "2"])


def test_train_cli_default_device_raises_without_a_card(no_card):
    from repro_torch.launch import lda_train

    with pytest.raises(RuntimeError, match="is_available"):
        lda_train.main(["--minibatches", "1"])


def test_packed_slice_modules_stand_alone(no_card):
    """The packed-policy slice's modules are among the files checked above,
    import nothing of JAX, and its entry points default to the card too."""
    import sys

    from repro_torch.core import pobp, sweep_dispatch
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import packed

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in (sweep_dispatch, packed, pack_ops):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    assert (ROOT / "src/repro_torch/csrc/power_sweep_tokens.cu").is_file()
    assert "triton" not in sys.modules
    cfg = LDAConfig(vocab_size=20, num_topics=4, sweep_policy="packed")
    with pytest.raises(RuntimeError, match="is_available"):
        pobp.make_train_step(cfg)
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state, diag = step(pobp.init_train_state(cfg, device="cpu"),
                       torch.zeros((1, 8), dtype=torch.int32),
                       torch.ones((1, 8)))
    assert state.m == 1 and diag["iters"] >= 1


def test_multishard_slice_modules_stand_alone(no_card):
    """The multi-shard slice's modules (the sync layer, the mesh, the
    sharded serving body) are among the files checked above and import
    nothing of JAX; its entry points default to the card too."""
    from repro_torch.core import infer, pobp, sync
    from repro_torch.core.types import LDAConfig
    from repro_torch.launch import lda_train, mesh
    from repro_torch.serve import SlabEngine

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in (sync, mesh, infer, pobp, lda_train):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    cfg = LDAConfig(vocab_size=20, num_topics=4)
    for build in (lambda: pobp.make_train_step(cfg, 2),
                  lambda: pobp.make_sim_minibatch_fn(cfg, 2),
                  lambda: infer.make_fold_in_step(cfg, topic_shards=2),
                  lambda: infer.make_slab_step(cfg, slots=2, slot_len=8,
                                               topic_shards=2),
                  lambda: SlabEngine(np.ones((20, 4), np.float32), cfg,
                                     slots=2, slot_len=8, topic_shards=2),
                  lambda: lda_train.main(["--minibatches", "1", "--backend",
                                          "shard_map", "--mesh-shape",
                                          "1,1"])):
        with pytest.raises(RuntimeError, match="is_available"):
            build()


def test_lifecycle_slice_modules_stand_alone(no_card):
    """The dynamic-vocabulary slice's modules (the lifecycle transitions,
    the vocabulary map, the drifting streams, the live-W selection and
    step, the driver) are among the files checked above and import nothing
    of JAX; its entry points default to the card too."""
    from repro_torch.core import lifecycle, perplexity, pobp, power
    from repro_torch.core.types import LDAConfig, MiniBatch
    from repro_torch.data import batching, synthetic, vocab
    from repro_torch.launch import lda_train
    from repro_torch.serve import engine

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "src/repro_torch/core/lifecycle.py" in names
    for mod in (lifecycle, vocab, synthetic, batching, power, perplexity,
                pobp, lda_train, engine):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    cfg = LDAConfig(vocab_size=64, num_topics=4)
    mb = MiniBatch(torch.zeros((1, 8), dtype=torch.int32), torch.ones((1, 8)))
    for build in (lambda: pobp.make_train_step(cfg),
                  lambda: perplexity.evaluate(torch.ones((64, 4)), mb, mb,
                                              cfg, live_w=40),
                  lambda: lda_train.main(["--minibatches", "1",
                                          "--dynamic-vocab", "--drift-mode",
                                          "slide", "--compact-every", "1"])):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    # asked for the CPU, a live-W step runs there
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state, diag = step(pobp.init_train_state(cfg, device="cpu"),
                       mb.word_ids, mb.counts, 40)
    assert state.m == 1 and not state.phi_acc[40:].any()


def test_lm_slice_modules_stand_alone(no_card):
    """The LM lab's modules (configs, models, the converter, the LM
    serving loop) are among the files checked above and import nothing of
    JAX; their entry points default to the card too."""
    from repro_torch import configs, convert
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import (attention, common, encdec, lm, mlp, moe,
                                    registry, ssm)

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "src/repro_torch/configs/zamba2_2_7b.py" in names
    for mod in (configs, base, convert, serve, attention, common, encdec,
                lm, mlp, moe, registry, ssm):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    cfg = configs.get_config("smollm-360m").reduced()
    for build in (lambda: lm.init(cfg),
                  lambda: encdec.init(configs.get_config(
                      "seamless-m4t-medium").reduced()),
                  lambda: registry.cache_zeros(cfg, 1, 4),
                  lambda: convert.lm_params_from_reference({}, cfg),
                  lambda: serve.main(["--mode", "lm", "--reduced"])):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    # the meta device draws nothing and needs no card
    assert lm.init(cfg, device="meta")["embed"].device.type == "meta"


def test_lm_training_slice_modules_stand_alone(no_card):
    """The LM trainer's modules (the ``optim`` subpackage, the token
    stream, the driver) are among the files checked above and import
    nothing of JAX; their entry points default to the card too."""
    from repro_torch import optim
    from repro_torch.data import lm_data
    from repro_torch.launch import train
    from repro_torch.optim import adamw, powersync

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("src/repro_torch/optim/__init__.py",
                "src/repro_torch/optim/adamw.py",
                "src/repro_torch/optim/powersync.py"):
        assert rel in names
    for mod in (optim, adamw, powersync, lm_data, train):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    for build in (lambda: train.main(["--reduced", "--steps", "1"]),
                  lambda: lm_data.batch_at(0, 0, 2, 4, 10)):
        with pytest.raises(RuntimeError, match="is_available"):
            build()


def test_dry_run_slice_modules_stand_alone(no_card):
    """The last slice's modules (the sharding rule table, the roofline,
    the dry run) are among the files checked above and import nothing of
    JAX; importing them joins no process group; and every module of the
    JAX package now has a counterpart in the port but the Pallas kernels
    (``kernels/*/kernel.py``, whose counterparts are ``csrc/*.cu``) and
    their oracles (``kernels/*/ref.py``, whose counterparts are each
    kernel's plain version in ``ops.py``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import registry

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in (sharding, roofline, dryrun):
        rel = str(Path(mod.__file__).resolve().relative_to(ROOT))
        assert rel in names
        assert not [m for m in _imported_modules(Path(mod.__file__))
                    if _forbidden(m)]
    assert not dist.is_initialized()
    ref = {str(p.relative_to(ROOT / "src" / "repro"))
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {str(p.relative_to(ROOT / "src" / "repro_torch"))
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert sorted(ref - port) == [
        f"kernels/{k}/{f}.py" for k in ("bp_update", "power_pack",
                                        "power_sweep")
        for f in ("kernel", "ref")]
    # shapes only: the meta cache needs no card
    cache = registry.cache_specs(get_config("smollm-360m"), 2, 8)
    assert cache["stack"]["k"].device.type == "meta"
