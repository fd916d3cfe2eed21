"""Checkpoints in the TPU package's .npz format (blp_tpu/checkpoint.py).

One .npz holds the tree's leaves as `leaf_00000`, ... in JAX tree-flatten
order (dict keys sorted, lists and tuples in order), the tree's shape as
JSON (`__structure__`), the leaves' dtype names (`__leaf_dtypes__`) and a
metadata blob (`__metadata__`). Files written by either package load in the
other. bfloat16 leaves are stored as 2-byte void (`V2`) arrays, as numpy
stores the TPU package's `ml_dtypes` bfloat16, and are viewed back as
`torch.bfloat16` on load (this package needs no `ml_dtypes`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return ["__tuple__", [_structure(v) for v in tree]]
    if isinstance(tree, list):
        return ["__list__", [_structure(v) for v in tree]]
    return None


def _leaves(tree) -> list:
    """Leaves in JAX tree-flatten order (None is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.uint16).numpy()
            return raw.view(np.dtype("V2")), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, a.dtype.name


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    pairs = [_to_numpy(v) for v in _leaves(tree)]
    arrays = {f"leaf_{i:05d}": a for i, (a, _) in enumerate(pairs)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        structure = json.dumps(_structure(tree))
    except TypeError:
        structure = "null"
    dtypes = json.dumps([name for _, name in pairs])
    np.savez(path, __metadata__=json.dumps(metadata or {}),
             __structure__=structure, __leaf_dtypes__=dtypes, **arrays)


def _rebuild(structure, leaves: list):
    if structure is None:
        return leaves.pop(0)
    if isinstance(structure, dict):
        return {k: _rebuild(structure[k], leaves) for k in sorted(structure)}
    kind, children = structure
    seq = [_rebuild(c, leaves) for c in children]
    return seq if kind == "__list__" else tuple(seq)


def peek_metadata(path: str) -> dict:
    """Read only the metadata blob."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__metadata__"]))


def _to_tensor(a: np.ndarray, name: str | None) -> torch.Tensor:
    if a.dtype.kind == "V":
        if name != "bfloat16" or a.dtype.itemsize != 2:
            raise ValueError(f"cannot restore a leaf stored as {a.dtype} "
                             f"with recorded dtype {name!r}")
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def load_pytree(path: str):
    """Returns (tree of CPU tensors, metadata). The tree is rebuilt from the
    file's `__structure__`; files without one cannot be restored here."""
    with np.load(path, allow_pickle=False) as data:
        metadata = json.loads(str(data["__metadata__"]))
        structure = json.loads(str(data["__structure__"]))
        names = (json.loads(str(data["__leaf_dtypes__"]))
                 if "__leaf_dtypes__" in data.files else None)
        arrays = [data[k] for k in sorted(data.files) if k.startswith("leaf_")]
    if structure is None:
        raise ValueError(f"{path} has no __structure__ record to restore its tree")
    leaves = [_to_tensor(a, names[i] if names else None)
              for i, a in enumerate(arrays)]
    return _rebuild(structure, leaves), metadata
