"""The data- and tensor-parallel train step over a ("data", "model") mesh
(port of blp_tpu/parallel/train_parallel.py).

The step is the one-device step split over ranks, with its semantics:
- each "data" rank encodes its rows of the batch, and the entity embeddings
  and relations are gathered over "data" (with autograd) before scoring, so
  the in-batch negatives index the GLOBAL (2B, d) entity view, as on one
  device (the reference's torch DataParallel re-sampled per replica, an
  artifact of replica scatter);
- `neg_idx` is drawn from the step's seed on every rank, over the global B,
  and K3 (`sddmm_pallas=True`) scores the whole batch on every rank;
- under tensor parallelism each "model" rank runs its share of the heads and
  FFN columns (models/bert.py `Part`, Megatron's conjugate pair);
- every dropout mask is the slice of the mask one device draws for the whole
  batch (models/bert.py `Part`), so the step drops the elements the
  one-device step drops — when the pack of a rank's rows equals the whole
  batch's (`with_batch_pack`), which holds for every batch whose rank-local
  entity rows divide by 4 at L <= 32.

Gradients: every rank computes the same loss from the same gathered tensors,
so the gradient arriving at the gather is the same on every rank, and its
backward hands each rank the slice for its own rows, unscaled. A leaf the
encoder reaches then holds its rows' share of the gradient and is summed
over "data"; `rel_emb`, read only after the gather, already holds the whole
gradient on every rank and is not reduced. The sum is the one-device
gradient, up to the order of the additions. Under tensor parallelism a
column- or row-parallel leaf's gradient is whole for its slice, and a
replicated leaf's is the same on every "model" rank (Megatron's pair sums
the activation gradients), so nothing is reduced over "model". Adam runs on
each rank's slice with that gradient, so its state follows the slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blp_tpu_torch import training
from blp_tpu_torch.checkpoint import tree_leaves, tree_unflatten
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.sampling import sample_negative_indices
from blp_tpu_torch.models import bert as bert_mod
from blp_tpu_torch.models import blp
from blp_tpu_torch.parallel import comm
from blp_tpu_torch.parallel import mesh as mesh_lib

#: Leaves read only after the gather over "data": their gradient is whole on
#: every rank and is not summed.
AFTER_GATHER = ("rel_emb",)


def axis(mesh, name: str) -> comm.Axis | None:
    """The mesh's axis `name` as this rank sees it; None when the mesh has
    no such axis."""
    if name not in (mesh.mesh_dim_names or ()):
        return None
    return comm.Axis.of(mesh, name)


def model_axis(mesh) -> comm.Axis | None:
    """The "model" axis when it has more than one rank, else None."""
    ax = axis(mesh, "model")
    return ax if ax is not None and ax.size > 1 else None


def init_parallel_state(params, optimizer, mesh, *, tensor_parallel: bool = True,
                        opt_state=None):
    """This rank's slice of the full parameter tree `params` (and of a full
    `opt_state`, when resuming), and its optimizer state.

    Returns (params, opt_state, split): `split` is the slicing rule
    (parallel/mesh.py) that `gather_state` inverts, or None when every leaf
    is replicated."""
    model = model_axis(mesh) if tensor_parallel else None
    split = mesh_lib.tp_split if model is not None else None
    if split is not None:
        params = mesh_lib.shard_tree(params, model.size, model.rank, split)
        if opt_state is not None:
            opt_state = mesh_lib.shard_tree(opt_state, model.size, model.rank, split)
    if opt_state is None:
        opt_state = optimizer.init(params)
    return params, opt_state, split


def gather_state(tree, mesh, split):
    """The full tree from every "model" rank's slice (a collective)."""
    model = model_axis(mesh)
    if split is None or model is None:
        return tree
    return mesh_lib.gather_tree(tree, model, split)


def local_rows(n: int, data: comm.Axis | None) -> slice:
    """This rank's contiguous block of n global batch rows."""
    if data is None or data.size == 1:
        return slice(0, n)
    if n % data.size:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"{data.size} data ranks")
    b = n // data.size
    return slice(data.rank * b, (data.rank + 1) * b)


def shard_batch(batch: dict, mesh, device) -> dict:
    """This rank's rows of a host batch of the whole step, on `device`."""
    rows = local_rows(len(next(iter(batch.values()))), axis(mesh, "data"))
    return prefetch.to_device({k: np.asarray(v)[rows] for k, v in batch.items()},
                              device)


def with_batch_pack(enc: bert_mod.BertConfig, rows_total: int,
                    rows_local: int, seq: int) -> bert_mod.BertConfig:
    """`enc` with the sequence pack of the whole batch where it divides this
    rank's rows (else the largest that divides both), so the packed rows —
    and the dropout masks drawn over them — lie as on one device."""
    if enc.seq_pack != "auto":
        return enc
    pack = next((p for p in (4, 2) if rows_total % p == 0
                 and rows_local % p == 0 and p * seq <= 128), 1)
    return dataclasses.replace(enc, seq_pack=pack)


def reduce_gradients(grads, data: comm.Axis | None):
    """Sum every gradient over "data" except AFTER_GATHER's, in one
    collective over a flat buffer."""
    if data is None or data.size == 1:
        return grads
    keep = {k: grads[k] for k in AFTER_GATHER if k in grads}
    rest = {k: v for k, v in grads.items() if k not in keep}
    return {**comm.all_reduce_tree(rest, data), **keep}


def parallel_value_and_grad(params, cfg: blp.ModelConfig, batch: dict, *,
                            dropout_seed: int, data: comm.Axis | None,
                            model: comm.Axis | None):
    """(loss, grads) of this rank's share of the step (see the module doc);
    `batch` holds this rank's rows and the global `neg_idx`."""
    n_local = len(batch["rels"])
    n = n_local * (1 if data is None else data.size)
    start = 0 if data is None else data.rank * n_local
    if cfg.model == "blp":
        seq = batch["text_tok"].shape[-1]
        cfg = dataclasses.replace(cfg, encoder=with_batch_pack(
            cfg.encoder, 2 * n, 2 * n_local, seq))
    part = bert_mod.Part(rows=(2 * start, 2 * n), model=model)
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = blp.train_loss(tree_unflatten(params, live), cfg, batch,
                          deterministic=False, dropout_seed=dropout_seed,
                          part=part, gather=lambda x: comm.gather_rows(x, data))
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), reduce_gradients(tree_unflatten(params, grads), data)


def make_parallel_train_step(cfg: blp.ModelConfig, optimizer, *, mesh,
                             batch_size: int, num_negatives: int, device):
    """step(params, opt_state, key, batch) -> (params, opt_state, loss):
    `batch` is this rank's rows (`shard_batch`, or the per-host data path of
    parallel/multihost.py), `params` and `opt_state` its slices
    (`init_parallel_state`); `loss` is the loss of the whole batch, the same
    on every rank."""
    dev = torch.device(device)
    data, model = axis(mesh, "data"), model_axis(mesh)
    if model is not None and cfg.model != "blp":
        model = None     # only the BERT layers split over "model"

    def step(params, opt_state, key, batch):
        neg_seed, drop_seed = training.step_seeds(key)
        gen = torch.Generator(device=dev).manual_seed(neg_seed)
        batch = dict(batch)
        batch["neg_idx"] = sample_negative_indices(gen, batch_size,
                                                   num_negatives, dev)
        loss, grads = parallel_value_and_grad(params, cfg, batch,
                                              dropout_seed=drop_seed,
                                              data=data, model=model)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return training.apply_updates(params, updates), opt_state, loss

    return step
