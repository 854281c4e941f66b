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


def test_cli_default_device_raises_without_a_card(no_card, tmp_path):
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import serve as serve_mod

    ckpt.save(str(tmp_path), 1,
              {"state": {"phi_acc": np.ones((20, 4), np.float32)}},
              extra={"run": {"vocab": 20, "topics": 4}})
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.main(["--mode", "lda", "--ckpt-dir", str(tmp_path),
                        "--requests", "2"])
