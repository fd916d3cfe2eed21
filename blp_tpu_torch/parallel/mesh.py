"""Device meshes and the slicing of parameters over them (port of
blp_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the whole world,
with the TPU package's axis names: ("data", "model") for data and tensor
parallelism, ("data", "pipe") for the pipeline. Its size must equal the
world size; nothing quietly runs on fewer ranks.

Where JAX gives each leaf a PartitionSpec and lets GSPMD place it, a rank
here holds the slice of each leaf the spec assigns it:
- "model": the Megatron layout of the BERT layers (`TP_SPLIT`, the TPU
  package's `_BERT_TP_SPECS`): q, k, v and ffn_in split by columns (a rank
  runs num_heads / M heads and its share of the FFN), attn_out and ffn_out by
  rows; everything else replicated;
- "pipe": the stacked (num_layers, ...) layer leaves split on the layer
  axis, a contiguous block of layers per stage; everything else replicated.
The rules read a leaf's path, so they cover a parameter tree in either layer
layout and an optimizer state that holds such trees (Adam's mu and nu).
`shard_tree` takes a rank's slice of a full tree; `gather_tree` rebuilds the
full tree from every rank's slice, for checkpoints and evaluation.
"""

from __future__ import annotations

import torch

from blp_tpu_torch.parallel import comm
from blp_tpu_torch.utils import resolve_device

#: The split axis of each tensor-parallel layer leaf, counted from the end,
#: so one rule covers stacked (L, ...) and per-layer leaves: -1 column
#: parallel, -2 row parallel. Leaves not listed are replicated.
TP_SPLIT = {"q_w": -1, "q_b": -1, "k_w": -1, "k_b": -1, "v_w": -1, "v_b": -1,
            "ffn_in_w": -1, "ffn_in_b": -1, "attn_out_w": -2, "ffn_out_w": -2}


def make_mesh(num_data: int, num_other: int = 1, *, other: str = "model",
              device=None):
    """A (data, `other`) DeviceMesh over the world, on `device`'s type
    (default cuda). Raises ValueError when the mesh size differs from the
    world size, before it looks at the device."""
    from torch.distributed.device_mesh import init_device_mesh

    world = comm.world_size()
    if num_data * num_other != world:
        raise ValueError(f"mesh data={num_data} x {other}={num_other} "
                         f"({num_data * num_other} ranks) != world size {world}")
    return init_device_mesh(resolve_device(device).type, (num_data, num_other),
                            mesh_dim_names=("data", other))


def _layer_leaf(path: tuple):
    """(leaf name, stacked?) of a path ending in a BERT layer leaf, else
    None. Paths run through "layers", then the leaf name (stacked) or a
    layer index and the name (unstacked)."""
    if "layers" not in path:
        return None
    rest = path[len(path) - path[::-1].index("layers"):]
    if len(rest) == 1 and isinstance(rest[0], str):
        return rest[0], True
    if len(rest) == 2 and isinstance(rest[0], int):
        return rest[1], False
    return None


def tp_split(path: tuple, leaf) -> int | None:
    """The "model" axis rule: the dim a leaf is split on, or None."""
    found = _layer_leaf(path)
    return None if found is None else TP_SPLIT.get(found[0])


def pipe_split(path: tuple, leaf) -> int | None:
    """The "pipe" axis rule: stacked layer leaves split on the layer axis."""
    found = _layer_leaf(path)
    if found is None:
        return None
    if not found[1]:
        raise ValueError("the pipeline slices the stacked layer layout")
    return 0


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def shard_tree(tree, axis_size: int, axis_rank: int, split):
    """The slice of every leaf that rank `axis_rank` of an axis of
    `axis_size` holds under rule `split` (a contiguous copy per split leaf;
    replicated leaves are returned as they are)."""
    def take(path, leaf):
        dim = split(path, leaf)
        if dim is None or axis_size == 1:
            return leaf
        n = leaf.shape[dim]
        if n % axis_size:
            raise ValueError(f"{'/'.join(map(str, path))}: {n} does not split "
                             f"over {axis_size} ranks")
        step = n // axis_size
        return leaf.narrow(dim, axis_rank * step, step).contiguous()
    return _map(tree, take)


def gather_tree(tree, axis: comm.Axis, split):
    """The full tree from every rank's slice along `axis` (a collective:
    every rank of the axis calls it)."""
    def join(path, leaf):
        dim = split(path, leaf)
        if dim is None or axis.size == 1:
            return leaf
        return torch.cat(comm.all_gather(leaf.contiguous(), axis), dim=dim)
    return _map(tree, join)
