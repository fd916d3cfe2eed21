"""Checkpoint files cross between the packages in both directions
(blp_tpu_torch/checkpoint.py vs blp_tpu/checkpoint.py): same leaves, same
dtypes, bfloat16 leaves included."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from blp_tpu import checkpoint as j_ckpt
from blp_tpu_torch import checkpoint as t_ckpt


def _jax_tree(rng):
    return {
        "rel_emb": rng.standard_normal((3, 4)).astype(np.float32),
        "bert": {"layers": ({"w": rng.standard_normal((2, 2)).astype(np.float32)},
                            {"w": rng.standard_normal((2, 2)).astype(np.float32)}),
                 "mu": np.asarray(jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16))},
        "step": np.asarray(7, np.int64),
        "ids": [np.arange(3, dtype=np.int32)],
    }


def test_jax_file_loads_in_port(tmp_path):
    tree = _jax_tree(np.random.default_rng(0))
    path = str(tmp_path / "j.npz")
    j_ckpt.save_pytree(path, tree, metadata={"epoch": 3})
    got, meta = t_ckpt.load_pytree(path)
    assert meta == {"epoch": 3} == t_ckpt.peek_metadata(path)
    assert isinstance(got["bert"]["layers"], tuple) and isinstance(got["ids"], list)
    np.testing.assert_array_equal(got["rel_emb"].numpy(), tree["rel_emb"])
    np.testing.assert_array_equal(got["bert"]["layers"][1]["w"].numpy(),
                                  tree["bert"]["layers"][1]["w"])
    assert got["bert"]["mu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bert"]["mu"].view(torch.uint16).numpy(),
                                  tree["bert"]["mu"].view(np.uint16))
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 7
    assert got["ids"][0].dtype == torch.int32


def test_port_file_loads_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    tree = {
        "a": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)),
        "b": (torch.arange(4, dtype=torch.int64),
              torch.from_numpy(rng.standard_normal(6).astype(np.float32)).to(torch.bfloat16)),
        "c": {"z": torch.ones(2), "y": torch.zeros(1)},
    }
    path = str(tmp_path / "t.npz")
    t_ckpt.save_pytree(path, tree, metadata={"who": "port"})
    got, meta = j_ckpt.load_pytree(path)
    assert meta == {"who": "port"}
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    np.testing.assert_array_equal(got["b"][0], tree["b"][0].numpy())
    assert got["b"][1].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["b"][1].view(np.uint16),
                                  tree["b"][1].view(torch.uint16).numpy())
    np.testing.assert_array_equal(got["c"]["z"], np.ones(2, np.float32))
    # And back through the port unchanged.
    again, _ = t_ckpt.load_pytree(path)
    assert torch.equal(again["b"][1], tree["b"][1])


def test_zero_d_leaves_and_template_load_cross_packages(tmp_path):
    """0-d leaves (an optimizer's counts) stay 0-d both ways, and a template
    load unflattens in JAX's order, as blp_tpu.checkpoint does."""
    import jax

    tree = {"p": {"w": torch.ones((2, 3)), "b": torch.zeros(3)},
            "s": ((torch.tensor(4, dtype=torch.int32), {"w": torch.ones((2, 3))}),
                  (torch.tensor(9, dtype=torch.int32),), ())}
    path = str(tmp_path / "s.npz")
    t_ckpt.save_pytree(path, tree, {"layout": "stacked"})
    assert t_ckpt.peek_num_leaves(path) == 5
    got, _ = t_ckpt.load_pytree(path)
    assert got["s"][0][0].shape == () and int(got["s"][1][0]) == 9
    with np.testing.assert_raises(ValueError):
        t_ckpt.load_pytree(path, template={"only": "one"})
    jgot, _ = j_ckpt.load_pytree(path, template=jax.tree.map(
        np.asarray, t_ckpt.tree_unflatten(tree, [x.numpy() for x in
                                                 t_ckpt.tree_leaves(tree)])))
    assert np.asarray(jgot["s"][0][0]).shape == ()
    back, _ = t_ckpt.load_pytree(path, template=tree)
    for a, b in zip(t_ckpt.tree_leaves(back), t_ckpt.tree_leaves(tree)):
        assert a.shape == b.shape and torch.equal(a, b)
