"""Checkpoints cross between the packages bit for bit: the port restores
what ``repro.dist.checkpoint.save`` wrote (float32 and bfloat16), and the
JAX package restores what the port saved.  ``convert.phi_from_reference``
carries a JAX phi into the port unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro_torch import convert
from repro_torch.dist import checkpoint as ckpt

W, K = 150, 16


def _phi(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.gamma(0.3, 20.0, (W, K))).astype(np.float32)


def _bits(x: torch.Tensor) -> np.ndarray:
    """The raw bit pattern of a float32/bfloat16 tensor."""
    t = x.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_restores_jax_checkpoint_bit_exactly(tmp_path, dtype):
    phi = jnp.asarray(_phi()).astype(dtype)
    jckpt.save(str(tmp_path), 4,
               {"state": {"phi_acc": phi, "m": jnp.asarray(4, jnp.int32),
                          "rng": jax.random.PRNGKey(0)}},
               extra={"next_m": 4, "run": {"vocab": W, "topics": K}})
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.verify_step(str(tmp_path), 4) is None
    got, extra, step = ckpt.restore_phi(str(tmp_path))
    assert step == 4 and extra["run"]["topics"] == K
    assert got.shape == (W, K)
    want = np.asarray(phi)
    if dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), want.view(np.int16))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    # dtype= upcasts exactly as the reference's restore_phi(dtype=) does
    up, _, _ = ckpt.restore_phi(str(tmp_path), dtype=torch.float32)
    jup, _, _ = jckpt.restore_phi(str(tmp_path), dtype=jnp.float32)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jax_restores_port_checkpoint_bit_exactly(tmp_path, dtype):
    phi = torch.from_numpy(_phi(1)).to(dtype)
    ckpt.save(str(tmp_path), 9,
              {"state": {"phi_acc": phi,
                         "m": torch.tensor(9, dtype=torch.int32),
                         "rng": np.zeros(2, np.uint32)}},
              extra={"run": {"vocab": W, "topics": K}})
    assert jckpt.verify_step(str(tmp_path), 9) is None
    got, extra, step = jckpt.restore_phi(str(tmp_path))
    assert step == 9 and extra["run"]["vocab"] == W
    got = np.asarray(got)
    assert got.shape == (W, K) and got.dtype.name == str(dtype)[6:]
    np.testing.assert_array_equal(
        got.view(np.int16 if dtype == torch.bfloat16 else np.int32),
        _bits(phi))
    # the reference's template-driven restore reads the same tree back
    tree, _, _ = jckpt.restore(
        str(tmp_path), 9,
        {"state": {"phi_acc": jnp.zeros((W, K), got.dtype),
                   "m": jnp.asarray(0, jnp.int32),
                   "rng": jnp.zeros(2, jnp.uint32)}})
    assert int(tree["state"]["m"]) == 9


def test_restore_phi_errors_and_retention(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_phi(str(tmp_path / "empty"))
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"state": {"phi_acc": _phi(s)}})
    assert sorted(ckpt._all_steps(str(tmp_path))) == [3, 4, 5]
    with pytest.raises(ValueError, match="0 leaves"):
        ckpt.restore_phi(str(tmp_path), leaf="nope")
    leaf = tmp_path / "step_0000005" / "data.npz"
    leaf.write_bytes(leaf.read_bytes()[:100])
    assert ckpt.verify_step(str(tmp_path), 5) is not None
    assert ckpt.verify_step(str(tmp_path), 4) is None


def test_phi_from_reference_round_trips():
    phi = _phi(2)
    got = convert.phi_from_reference(phi, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (W, K)
    np.testing.assert_array_equal(got.numpy(), phi)
    # a bfloat16 JAX statistic (ml_dtypes numpy) arrives up-cast exactly
    jb = np.asarray(jnp.asarray(phi).astype(jnp.bfloat16))
    got_b = convert.phi_from_reference(jb, live_words=W - 3, device="cpu")
    np.testing.assert_array_equal(got_b.numpy(),
                                  np.asarray(jb.astype(np.float32)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convert.phi_from_reference(phi.astype(np.float64), device="cpu")
    with pytest.raises(ValueError, match=r"\[W, K\]"):
        convert.phi_from_reference(phi[0], device="cpu")
    with pytest.raises(ValueError, match="live_words"):
        convert.phi_from_reference(phi, live_words=W + 1, device="cpu")
