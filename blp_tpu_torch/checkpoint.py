"""Checkpoints in the TPU package's .npz format (blp_tpu/checkpoint.py).

One .npz holds the tree's leaves as `leaf_00000`, ... in JAX tree-flatten
order (dict keys sorted, lists and tuples in order), the tree's shape as
JSON (`__structure__`), the leaves' dtype names (`__leaf_dtypes__`) and a
metadata blob (`__metadata__`). Files written by either package load in the
other. bfloat16 leaves are stored as 2-byte void (`V2`) arrays, as numpy
stores the TPU package's `ml_dtypes` bfloat16, and are viewed back as
`torch.bfloat16` on load (this package needs no `ml_dtypes`).

A tree is nested dicts, tuples and lists of tensors (or numpy arrays);
`tree_leaves` and `tree_unflatten` walk it in JAX's flatten order, so an
optimizer state shaped like optax's, ((count, mu, nu), (sched_count,)),
has the same leaf order as the TPU package's and its files load in either
package.
"""

from __future__ import annotations

import json
import os
import zipfile

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


def tree_leaves(tree) -> list:
    """Leaves in JAX tree-flatten order (dict keys sorted; None is an empty
    subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like `template` whose leaves are `leaves`, taken in
    tree_leaves order (the inverse of tree_leaves)."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    out = rebuild(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


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
    pairs = [_to_numpy(v) for v in tree_leaves(tree)]
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


def peek_num_leaves(path: str) -> int:
    """Number of stored leaves (no data read)."""
    with np.load(path, allow_pickle=False) as data:
        return sum(1 for k in data.files if k.startswith("leaf_"))


def peek_leaf_shapes(path: str) -> list[tuple]:
    """Shapes of the stored leaves in load order, read from the .npy headers
    only (no array data). Tells the stacked and unstacked layouts of a
    marker-less state file apart where their leaf counts coincide
    (num_layers == 1: a stacked layer leaf is (1, ...), an unstacked one
    (...))."""
    from numpy.lib import format as npf

    shapes = []
    with zipfile.ZipFile(path) as zf:
        for name in sorted(zf.namelist()):
            if not name.startswith("leaf_"):
                continue
            with zf.open(name) as f:
                # Format 1.0 has a 2-byte header length, 2.0 a 4-byte one
                # (np.savez writes 1.0 unless the header is over 64 KiB).
                read = (npf.read_array_header_1_0 if npf.read_magic(f) == (1, 0)
                        else npf.read_array_header_2_0)
                shape, _, _ = read(f)
            shapes.append(tuple(shape))
    return shapes


def _to_tensor(a: np.ndarray, name: str | None,
               like: torch.Tensor | None = None) -> torch.Tensor:
    """The stored array `a` as a CPU tensor. A void-typed leaf (numpy's form
    of bfloat16) is viewed through its recorded dtype `name`; a file without
    the record (a legacy file) uses the dtype of the template leaf `like`
    where the item sizes match."""
    if a.dtype.kind == "V":
        want = name
        if (want is None and like is not None
                and like.dtype.itemsize == a.dtype.itemsize):
            want = str(like.dtype).removeprefix("torch.")
        if want != "bfloat16" or a.dtype.itemsize != 2:
            raise ValueError(f"cannot restore a leaf stored as {a.dtype} "
                             f"with recorded dtype {name!r}")
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))   # keeps 0-d leaves 0-d


def load_pytree(path: str, template=None):
    """Returns (tree of CPU tensors, metadata). With `template`, the leaves
    are unflattened into the template's tree in JAX's flatten order (its
    leaves give the count, and the dtype of a void-typed leaf in a file
    without dtype records; they may live on the `meta` device);
    otherwise the tree is rebuilt from the file's `__structure__`."""
    with np.load(path, allow_pickle=False) as data:
        metadata = json.loads(str(data["__metadata__"]))
        structure = json.loads(str(data["__structure__"]))
        names = (json.loads(str(data["__leaf_dtypes__"]))
                 if "__leaf_dtypes__" in data.files else None)
        arrays = [data[k] for k in sorted(data.files) if k.startswith("leaf_")]
    like = tree_leaves(template) if template is not None else None
    if like is not None and len(like) != len(arrays):
        raise ValueError(f"{path} holds {len(arrays)} leaves, the "
                         f"template {len(like)}")
    leaves = [_to_tensor(a, names[i] if names else None,
                         like[i] if like is not None else None)
              for i, a in enumerate(arrays)]
    if template is not None:
        return tree_unflatten(template, leaves), metadata
    if structure is None:
        raise ValueError(f"{path} has no __structure__ record to restore its tree")
    return _rebuild(structure, leaves), metadata
