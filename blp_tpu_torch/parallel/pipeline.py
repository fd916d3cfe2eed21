"""GPipe pipeline parallelism of the BLP BERT encoder over a ("data",
"pipe") mesh (port of blp_tpu/parallel/pipeline.py).

- Stage s holds a contiguous block of the stacked (num_layers, ...) layer
  leaves (parallel/mesh.py `pipe_split`); everything else is replicated.
- Every stage embeds its data rank's rows (the embeddings are small), and
  the packed rows are cut into `num_microbatches`. Stage 0 feeds its layers
  from the embeddings, a later stage from the activations the previous
  stage sends; microbatches move by send and recv (parallel/comm.py).
- The last stage's hidden states are broadcast to every stage of the pipe,
  and every stage forms the [CLS] projection and the loss of the GLOBAL
  batch (entity embeddings gathered over "data"), as the one-device step.
- The backward is GPipe's: the loss's gradient reaches the broadcast hidden
  states on every stage; the last stage runs `torch.autograd.backward` on
  each microbatch's stashed outputs (the activations are kept from the
  forward) with its slice, in reverse order, and sends the gradient of the
  microbatch's input upstream, where the same repeats; stage 0 finally
  backpropagates into the embeddings. torch.distributed.pipelining is not
  used: the stash-and-send loop is a few lines and keeps the schedule, the
  dropout slicing and the collectives in view.
- Gradients: a stage's layer leaves are whole for its block; the embedding
  leaves get theirs on stage 0 alone and are summed over "pipe" (exact:
  zeros elsewhere); `proj` and `rel_emb`, applied on every stage to the
  same broadcast states, hold the whole gradient everywhere. Over "data"
  everything but `rel_emb` is summed, as in parallel/train_parallel.py.
- Dropout: each microbatch draws the rows of the one-device step's masks
  (models/bert.py `Part`), with the seeds of the global layer index, so the
  pipelined step drops what the one-device step drops. (The TPU package's
  pipeline keys its masks per microbatch: the same distribution, other
  bits.)
"""

from __future__ import annotations

import torch

from blp_tpu_torch import training
from blp_tpu_torch.checkpoint import tree_leaves, tree_unflatten
from blp_tpu_torch.data.sampling import sample_negative_indices
from blp_tpu_torch.models import bert as bert_mod
from blp_tpu_torch.models import blp, scoring
from blp_tpu_torch.parallel import comm
from blp_tpu_torch.parallel import mesh as mesh_lib
from blp_tpu_torch.parallel import train_parallel
from blp_tpu_torch.utils import resolve_device


def make_pipeline_mesh(num_data: int, num_pipe: int, device=None):
    """A (data, pipe) DeviceMesh over the world (default cuda)."""
    return mesh_lib.make_mesh(num_data, num_pipe, other="pipe", device=device)


def shard_pipeline_params(params: dict, mesh) -> dict:
    """This stage's slice of a full tree in the stacked layer layout (also an
    optimizer state over one)."""
    pipe = comm.Axis.of(mesh, "pipe")
    return mesh_lib.shard_tree(params, pipe.size, pipe.rank, mesh_lib.pipe_split)


def gather_pipeline_params(tree, mesh):
    """The full tree from every stage's slice (a collective)."""
    return mesh_lib.gather_tree(tree, comm.Axis.of(mesh, "pipe"),
                                mesh_lib.pipe_split)


def check_config(cfg: blp.ModelConfig, num_pipe: int) -> None:
    if cfg.model != "blp":
        raise ValueError("pipeline parallelism applies to the BERT encoder "
                         f"(model='blp'), got {cfg.model!r}")
    if cfg.encoder.num_layers % num_pipe:
        raise ValueError(f"{cfg.encoder.num_layers} layers not divisible by "
                         f"pipe={num_pipe}")


def _stage_forward(enc, x_mb, mask_mb, layers, first: int, dropout_seed,
                   part: bert_mod.Part, remat_k: int):
    h = x_mb
    for i, lp in enumerate(layers):
        g = first + i
        seeds = (None if dropout_seed is None
                 else bert_mod.layer_seeds(dropout_seed, g))
        h = bert_mod.run_layer(enc, h, mask_mb, lp, seeds, part=part,
                               remat=g < remat_k)
    return h


def pipeline_value_and_grad(params, cfg: blp.ModelConfig, batch: dict, *,
                            mesh, num_microbatches: int,
                            dropout_seed: int | None):
    """(loss, grads) of one DP x PP step: `params` is this stage's slice,
    `batch` this data rank's rows plus the global `neg_idx`;
    dropout_seed=None runs deterministically."""
    data = train_parallel.axis(mesh, "data")
    pipe = comm.Axis.of(mesh, "pipe")
    stage, last = pipe.rank, pipe.size - 1
    tok = batch["text_tok"]
    b_local, two, seq = tok.shape
    n_data = 1 if data is None else data.size
    enc = train_parallel.with_batch_pack(cfg.encoder, 2 * b_local * n_data,
                                         2 * b_local, seq)
    mask = batch.get("text_mask")
    flat_mask = None if mask is None else mask.reshape(b_local * two, seq)

    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    p = tree_unflatten(params, live)
    bert = p["bert"]
    x, mask_bias, pack, _ = bert_mod.embed_inputs(
        bert, tok.reshape(b_local * two, seq), flat_mask, enc)
    bp = x.shape[0]
    if bp % num_microbatches:
        raise ValueError(f"local packed batch {bp} not divisible by "
                         f"num_microbatches={num_microbatches}")
    mb = bp // num_microbatches
    row0 = (0 if data is None else data.rank) * bp
    rows_total = bp * n_data
    if dropout_seed is not None:
        x = bert_mod.embed_dropout(x, dropout_seed, enc,
                                   bert_mod.Part(rows=(row0, rows_total)))
    mask_bias = mask_bias.expand(bp, *mask_bias.shape[1:])
    layers = bert_mod.unstack_layers(bert)["layers"]
    first = stage * len(layers)
    remat_k = bert_mod._remat_layers(enc) if dropout_seed is not None else 0

    # Forward: every microbatch through this stage, inputs and outputs kept.
    inputs, outputs = [], []
    for j in range(num_microbatches):
        rows = slice(j * mb, (j + 1) * mb)
        if stage == 0:
            h_in = x[rows].detach()
        else:
            h_in = comm.recv(torch.empty((mb, *x.shape[1:]), dtype=x.dtype,
                                         device=x.device), pipe.ranks[stage - 1])
        h_in.requires_grad_()
        part = bert_mod.Part(rows=(row0 + j * mb, rows_total))
        h = _stage_forward(enc, h_in, mask_bias[rows], layers, first,
                           dropout_seed, part, remat_k)
        if stage < last:
            comm.send(h.detach(), pipe.ranks[stage + 1])
        inputs.append(h_in)
        outputs.append(h)

    # The last stage's states to every stage; the loss on every stage.
    hidden = (torch.cat([o.detach() for o in outputs]) if stage == last
              else torch.empty_like(x))
    comm.broadcast(hidden, pipe.ranks[last], pipe)
    hidden.requires_grad_()
    h = hidden.reshape(b_local * two, seq, -1) if pack > 1 else hidden
    ent = torch.matmul(h[:, 0].to(torch.float32), p["proj"].to(torch.float32))
    if cfg.normalize_embs:
        ent = scoring.l2_normalize(ent)
    ent = comm.gather_rows(ent.reshape(b_local, two, -1), data)
    rels = comm.gather_rows(batch["rels"].reshape(-1), data)
    loss = blp.entity_loss(p, cfg, ent, rels, batch["neg_idx"])
    loss.backward()

    # Backward: microbatches in reverse, gradients sent upstream.
    for j in reversed(range(num_microbatches)):
        if stage == last:
            g = hidden.grad[j * mb:(j + 1) * mb]
        else:
            g = comm.recv(torch.empty_like(outputs[j]), pipe.ranks[stage + 1])
        torch.autograd.backward(outputs[j], g)
        if stage > 0:
            comm.send(inputs[j].grad, pipe.ranks[stage - 1])
    if stage == 0:
        torch.autograd.backward(x, torch.cat([i.grad for i in inputs]))

    grads = tree_unflatten(params, [torch.zeros_like(q) if q.grad is None
                                    else q.grad for q in live])
    # The embedding leaves' gradient lives on stage 0 alone.
    grads["bert"] = {**grads["bert"], "embeddings": comm.all_reduce_tree(
        grads["bert"]["embeddings"], pipe)}
    return loss.detach(), train_parallel.reduce_gradients(grads, data)


def make_pipeline_train_step(cfg: blp.ModelConfig, optimizer, *, mesh,
                             batch_size: int, num_negatives: int,
                             num_microbatches: int = 4, device=None,
                             deterministic: bool = False):
    """step(params, opt_state, key, batch) -> (params, opt_state, loss) of
    the DP x PP pipeline; params and opt_state are this stage's slices
    (`shard_pipeline_params`), batch this data rank's rows."""
    check_config(cfg, comm.Axis.of(mesh, "pipe").size)
    dev = resolve_device(device)

    def step(params, opt_state, key, batch):
        neg_seed, drop_seed = training.step_seeds(key)
        gen = torch.Generator(device=dev).manual_seed(neg_seed)
        batch = dict(batch)
        batch["neg_idx"] = sample_negative_indices(gen, batch_size,
                                                   num_negatives, dev)
        loss, grads = pipeline_value_and_grad(
            params, cfg, batch, mesh=mesh, num_microbatches=num_microbatches,
            dropout_seed=None if deterministic else drop_seed)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return training.apply_updates(params, updates), opt_state, loss

    return step
