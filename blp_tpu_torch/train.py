"""Training entry points: `link_prediction` on one device or over a mesh,
and `node_classification` on a run's embedding export.

    python -m blp_tpu_torch.train link_prediction with dataset=umls model=blp ...
    python -m blp_tpu_torch.train node_classification with dataset=... checkpoint=<run_id>

Port of blp_tpu/train.py. Reference behaviour mirrored: inductive and
transductive data selection, the filter graph with the large-dataset
(Wikidata5M) special case, per-epoch unfiltered train-sample and validation
eval, best-raw-MRR checkpointing, the final filtered valid and test eval from
the best checkpoint, and the entity-embedding export. The train step samples
negatives on the device; batches are assembled and copied ahead on a
background thread; losses stay on the device and are read one log interval
late; full-state checkpoints resume with `resume=auto` or a file path.

Runs on `device=` (default cuda). Over several processes — started by
`python -m torch.distributed.run --nproc-per-node N -m blp_tpu_torch.train
...`, or joined through the multi-host keys (`coordinator_address`,
`num_processes`, `process_id`) — it trains over a ("data", "model") mesh
(`num_data_shards` x `num_model_shards`: data and tensor parallelism,
parallel/train_parallel.py) or a ("data", "pipe") mesh (`num_pipe_shards`,
GPipe with `num_microbatches`, parallel/pipeline.py) and evaluates with the
candidate table split over every rank (parallel/eval_parallel.py). The mesh
must cover the world; each rank runs on cuda:LOCAL_RANK for device=cuda, or
on the device named. `multihost_data=True` has each rank read only its rows
of every batch (parallel/multihost.py). Rank 0 writes the checkpoints, in
the one-device format, so a run resumes under any layout.
`node_classification` fits the logistic regression of linear_model.py
(scikit-learn's default LogisticRegression, in torch) and writes
`classifier-<run_id>.npz` where the TPU package writes a joblib file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from blp_tpu_torch import checkpoint as ckpt
from blp_tpu_torch import evaluation, linear_model, observers, training
from blp_tpu_torch.config import ExperimentConfig, parse_overrides
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.datasets import GraphData, TextGraphData, load_maps
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.data.loader import (epoch_batches, num_batches,
                                       text_train_batch,
                                       transductive_train_batch)
from blp_tpu_torch.data.tokenizers import GloVeTokenizer, WordPieceTokenizer
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.parallel import comm, multihost, pipeline, train_parallel
from blp_tpu_torch.parallel import mesh as mesh_lib
from blp_tpu_torch.utils import (fold_seed, get_logger, load_embedding_export,
                                 make_ent2idx, resolve_device)

log = get_logger()


def make_tokenizer(cfg: ExperimentConfig):
    if cfg.model in ("blp", "bert-bow", "bert-dkrl"):
        vocab = cfg.vocab_file or osp.join(cfg.dataset_dir, "vocab.txt")
        if not osp.exists(vocab):
            raise FileNotFoundError(
                f"WordPiece vocab not found at {vocab}; there is no network "
                f"access — provide vocab_file= pointing at a local "
                f"bert-base-cased vocab.txt")
        return WordPieceTokenizer(vocab, do_lower_case=False)
    maps = cfg.glove_file or osp.join(cfg.data_dir, "glove", "glove.6B.300d-maps.pt")
    if maps.endswith(".pt"):
        maps_path = maps.replace(".pt", "-maps.pt") if "-maps" not in maps else maps
    else:
        maps_path = maps
    return GloVeTokenizer(maps_path)


def make_model_config(cfg: ExperimentConfig, tokenizer, num_relations: int,
                      num_entities: int) -> blp.ModelConfig:
    encoder = None
    emb_dim, vocab_size = 300, 0
    if cfg.model == "blp":
        vocab_size = len(tokenizer.vocab)
        numerics = dict(
            compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
            remat=cfg.remat, fast_train=cfg.fast_train,
            dropout_bits=cfg.dropout_bits)
        if cfg.encoder_name == "tiny":
            encoder = bert.BertConfig.tiny(vocab_size=max(vocab_size, 128),
                                           **numerics)
        else:
            encoder = bert.BertConfig(vocab_size=vocab_size, **numerics)
    elif cfg.model.startswith("bert"):
        vocab_size = len(tokenizer.vocab)
        emb_dim = 768 if cfg.encoder_name != "tiny" else 32
    elif cfg.model.startswith("glove"):
        # Rows for every id the tokenizer gives (0 is padding). The TPU
        # package sizes a random table len(word2idx), one row short, and its
        # gathers clamp the last id; a torch gather would raise.
        vocab_size = max(tokenizer.word2idx.values()) + 1
        emb_dim = 300
    return blp.ModelConfig(
        model=cfg.model, rel_model=cfg.rel_model, loss_fn=cfg.loss_fn,
        dim=cfg.dim, num_relations=num_relations, num_entities=num_entities,
        regularizer=cfg.regularizer, emb_dim=emb_dim, vocab_size=vocab_size,
        encoder=encoder)


def load_word_embeddings(cfg: ExperimentConfig):
    """Initial word table (a float32 CPU tensor) for the bow/dkrl models:
    BERT's word embeddings from `hf_weights` for the bert- variants, the
    GloVe tensor at `glove_file` for the glove- ones; None (random init)
    when there is no such file."""
    if cfg.model.startswith("glove"):
        path = cfg.glove_file or osp.join(cfg.data_dir, "glove", "glove.6B.300d.pt")
        if osp.exists(path):
            return torch.load(path, weights_only=False).to(torch.float32)
        log.warning(f"GloVe tensor {path} not found; using random init")
        return None
    if cfg.model.startswith("bert") and cfg.hf_weights and osp.exists(cfg.hf_weights):
        sd = torch.load(cfg.hf_weights, map_location="cpu", weights_only=False)
        for key in ("embeddings.word_embeddings.weight",
                    "bert.embeddings.word_embeddings.weight"):
            if key in sd:
                return sd[key].to(torch.float32)
    return None


def init_model_params(cfg: ExperimentConfig, mcfg: blp.ModelConfig, seed: int,
                      device) -> dict:
    """Random parameters from `seed` (a CPU generator, so every device gets
    the same weights), BERT weights from `hf_weights`, and the word table of
    `load_word_embeddings`."""
    hf_sd = None
    if cfg.model == "blp" and cfg.hf_weights and osp.exists(cfg.hf_weights):
        hf_sd = torch.load(cfg.hf_weights, map_location="cpu", weights_only=False)
        log.info(f"Loaded HF BERT weights from {cfg.hf_weights}")
    return blp.init_params(mcfg, torch.Generator().manual_seed(seed), device,
                           word_embeddings=load_word_embeddings(cfg),
                           hf_state_dict=hf_sd)


def _device_and_world(cfg: ExperimentConfig):
    """Join the world the keys or the launcher describe, and return this
    rank's device."""
    multihost.initialize(cfg.coordinator_address, cfg.num_processes,
                         cfg.process_id, device=cfg.device)
    if (cfg.num_data_shards * cfg.num_model_shards * cfg.num_pipe_shards > 1
            or comm.world_size() > 1):
        dev = comm.init_world(cfg.device)
    else:
        dev = torch.device(cfg.device)
    return resolve_device(dev)


def link_prediction(cfg: ExperimentConfig) -> dict:
    started = not torch.distributed.is_initialized()
    device = _device_and_world(cfg)
    run_id = cfg.run_id or time.strftime("%Y%m%d-%H%M%S")
    os.makedirs(cfg.out_dir, exist_ok=True)
    # Rank 0 keeps the metrics; the other ranks compute the same values.
    metrics_log = (observers.ObserverSet.from_env(cfg.out_dir, run_id)
                   if comm.world_rank() == 0 else observers.ObserverSet([]))
    # close() in a finally: a crash must still flush buffered sinks.
    try:
        metrics_log.log_config(dataclasses.asdict(cfg))
        return _link_prediction(cfg, run_id, metrics_log, device)
    finally:
        metrics_log.close()
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class _Layout:
    """How the live training state is split over the mesh, and the way back
    to the full one-device tree (for checkpoints and evaluation)."""

    def __init__(self, mesh, kind: str | None, split=None):
        self.mesh, self.kind, self.split = mesh, kind, split

    def full(self, tree):
        """The full tree from this rank's slice (a collective)."""
        if self.mesh is None:
            return tree
        if self.kind == "pipe":
            return pipeline.gather_pipeline_params(tree, self.mesh)
        return train_parallel.gather_state(tree, self.mesh, self.split)

    def live(self, params, opt_state):
        """This rank's slices of a full (stacked) params and optimizer
        state, in the training layout."""
        if self.kind == "pipe":
            return (pipeline.shard_pipeline_params(params, self.mesh),
                    pipeline.shard_pipeline_params(opt_state, self.mesh))
        params = training.unstack_params(params)
        opt_state = training.unstack_opt_state(opt_state)
        if self.split is not None:
            model = train_parallel.model_axis(self.mesh)
            params = mesh_lib.shard_tree(params, model.size, model.rank, self.split)
            opt_state = mesh_lib.shard_tree(opt_state, model.size, model.rank,
                                            self.split)
        return params, opt_state


def load_train_state(path: str, template: dict, optimizer):
    """((params, opt_state), metadata) of a state file, as CPU tensors in
    the stacked layout. `template` is the stacked params tree (shapes and
    dtypes only: it may live on the `meta` device).

    Files with the `"layout": "stacked"` marker are stacked. A marker-less
    (legacy) file was written in the layout its run trained in, so it is
    matched against the unstacked and the stacked templates by leaf count,
    then by leaf shape (with num_layers == 1 the counts coincide and only
    the leading (1,) axis of a stacked layer leaf tells them apart), and
    restacked when it is unstacked."""
    stacked = (template, optimizer.init(template))
    if ckpt.peek_metadata(path).get("layout") == "stacked":
        return ckpt.load_pytree(path, template=stacked)
    unstacked = (training.unstack_params(stacked[0]),
                 training.unstack_opt_state(stacked[1]))
    shapes = ckpt.peek_leaf_shapes(path)
    misses = []
    for name, tmpl in (("unstacked", unstacked), ("stacked", stacked)):
        want = [tuple(x.shape) for x in ckpt.tree_leaves(tmpl)]
        if want == shapes:
            (p_raw, o_raw), meta = ckpt.load_pytree(path, template=tmpl)
            return ((training.restack_params(p_raw),
                     training.restack_opt_state(o_raw)), meta)
        i = next((i for i, (a, b) in enumerate(zip(shapes, want)) if a != b),
                 min(len(shapes), len(want)))
        at = lambda xs: xs[i] if i < len(xs) else None  # noqa: E731
        misses.append(f"{name}: {len(want)} leaves, leaf {i} {at(want)} "
                      f"where the file has {at(shapes)}")
    raise ValueError(
        f"{path} ({len(shapes)} leaves, no layout marker) matches neither "
        f"state layout of this run: {'; '.join(misses)}")


def _save(path: str, tree, metadata: dict) -> None:
    """Rank 0 writes the (full, host) tree; every rank returns once it is
    written."""
    if comm.world_rank() == 0:
        ckpt.save_pytree(path, tree, metadata)
    if comm.world_size() > 1:
        torch.distributed.barrier()


def _link_prediction(cfg: ExperimentConfig, run_id: str,
                     metrics_log: observers.ObserverSet, device) -> dict:
    log.info(f"Run {run_id}: {cfg}")

    # ---- data ------------------------------------------------------------
    is_text = cfg.model != "transductive"
    if is_text:
        tokenizer = make_tokenizer(cfg)
        train_data = TextGraphData.load(
            cfg.triples_file("train"), tokenizer=tokenizer, max_len=cfg.max_len,
            drop_stopwords=cfg.model in blp.DROP_STOPWORD_MODELS,
            write_maps=True, use_cached_text=cfg.use_cached_text)
    else:
        tokenizer = None
        train_data = GraphData.load(cfg.triples_file("train"), write_maps=True)

    valid_data = GraphData.load(cfg.triples_file("dev"))
    test_data = GraphData.load(cfg.triples_file("test"))

    # Filter graph + new-entity sets (reference: train.py:296-315).
    train_ent = train_data.entities
    if not cfg.large_dataset:
        all_triples = np.concatenate(
            [train_data.triples, valid_data.triples, test_data.triples])
        filter_index = FilterIndex(all_triples)
        train_val_ent = np.unique(np.concatenate([train_ent, valid_data.entities]))
        train_val_test_ent = np.unique(
            np.concatenate([train_val_ent, test_data.entities]))
        val_new = np.setdiff1d(train_val_ent, train_ent)
        test_new = np.setdiff1d(train_val_test_ent, train_val_ent)
    else:
        filter_index = None
        train_val_ent = valid_data.entities
        train_val_test_ent = test_data.entities
        val_new = test_new = None
    metrics_log.log(0, num_train_entities=int(len(train_ent)))

    # ---- model + optimizer ----------------------------------------------
    # Transductive tables are sized by the id space (len(ent_ids)).
    mcfg = make_model_config(cfg, tokenizer, len(train_data.rel_ids),
                             len(train_data.ent_ids))
    params = init_model_params(cfg, mcfg, fold_seed(cfg.seed, 0xBEEF), device)
    if cfg.checkpoint:
        loaded, meta = ckpt.load_pytree(cfg.checkpoint, template=params)
        params = blp.to_device(loaded, device)
        log.info(f"Loaded checkpoint {cfg.checkpoint} ({meta})")

    steps_per_epoch = num_batches(train_data, cfg.batch_size)
    total_steps = max(steps_per_epoch * cfg.max_epochs, 1)
    optimizer = training.make_optimizer(cfg.lr, total_steps, cfg.use_scheduler,
                                        bf16_mu=cfg.adam_bf16_mu)
    # Training holds the BERT layers unstacked (one leaf per layer); files
    # and the final eval use the stacked layout. Adam's mu/nu mirror the
    # training layout. Under a mesh each rank holds its slice of both.
    full_template = blp.to_device(params, "meta")   # shapes only, no memory
    mesh, layout = None, _Layout(None, None)
    n_data, n_model, n_pipe = (cfg.num_data_shards, cfg.num_model_shards,
                               cfg.num_pipe_shards)
    if n_pipe > 1:
        if n_model > 1:
            raise ValueError("num_pipe_shards and num_model_shards are "
                             "mutually exclusive meshes (data x pipe vs "
                             "data x model)")
        if cfg.model != "blp":
            raise ValueError("pipeline parallelism slices the BERT layer "
                             f"stack (model='blp'); got model={cfg.model!r}")
        mesh = pipeline.make_pipeline_mesh(n_data, n_pipe, device=device)
        layout = _Layout(mesh, "pipe")
        params = pipeline.shard_pipeline_params(params, mesh)
        opt_state = optimizer.init(params)
        train_step = pipeline.make_pipeline_train_step(
            mcfg, optimizer, mesh=mesh, batch_size=cfg.batch_size,
            num_negatives=cfg.num_negatives,
            num_microbatches=cfg.num_microbatches, device=device)
    elif n_data * n_model > 1 or comm.world_size() > 1:
        mesh = mesh_lib.make_mesh(n_data, n_model, device=device)
        params, opt_state, split = train_parallel.init_parallel_state(
            training.unstack_params(params), optimizer, mesh,
            tensor_parallel=n_model > 1 and cfg.model == "blp")
        layout = _Layout(mesh, "dp" if split is None else "tp", split)
        train_step = train_parallel.make_parallel_train_step(
            mcfg, optimizer, mesh=mesh, batch_size=cfg.batch_size,
            num_negatives=cfg.num_negatives, device=device)
    else:
        params = training.unstack_params(params)
        opt_state = optimizer.init(params)
        train_step = training.make_train_step(
            mcfg, optimizer, batch_size=cfg.batch_size,
            num_negatives=cfg.num_negatives, device=device)
    if mesh is not None:
        log.info(f"Mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                 f"({layout.kind}) on {device}")

    def run_eval(eval_params, triples, entities, *, prefix, epoch,
                 filtered=False, new_entities=None, max_num_batches=None,
                 return_embeddings=False):
        res = evaluation.eval_link_prediction(
            eval_params, mcfg, triples, train_data, entities,
            batch_size=cfg.eval_batch_size, emb_batch_size=cfg.emb_batch_size,
            tile=cfg.tile, filter_index=filter_index if filtered else None,
            new_entities=new_entities,
            rel_categories=train_data.rel_categories if train_data.has_rel_categories else None,
            max_num_batches=max_num_batches,
            return_embeddings=return_embeddings, mesh=mesh, device=device,
            log=log)
        scalars = res.scalars(prefix)
        metrics_log.log(epoch, **scalars)
        log.info("  ".join(f"{k}: {v:.4f}" for k, v in scalars.items()))
        return res

    # ---- training loop ---------------------------------------------------
    # Seeds derive from (seed, epoch, step), so a resumed run replays the
    # remaining schedule exactly.
    best_mrr = 0.0
    start_epoch = 1
    ckpt_file = osp.join(cfg.out_dir, f"model-{run_id}.npz")
    best_ckpt = ckpt_file  # may be rebound to a prior run's file on resume
    state_file = osp.join(cfg.out_dir, f"train_state-{run_id}.npz")
    # resume="auto": this run's own state file if present (set run_id=);
    # otherwise resume= names a state file.
    resume_path = state_file if cfg.resume == "auto" else cfg.resume
    if resume_path and osp.exists(resume_path):
        # Every rank loads the full one-device state, then takes its slices
        # in the live layout.
        (p_raw, o_raw), meta = load_train_state(resume_path, full_template,
                                                optimizer)
        params, opt_state = blp.to_device(layout.live(p_raw, o_raw), device)
        start_epoch = int(meta["epoch"]) + 1
        best_mrr = float(meta.get("best_mrr", 0.0))
        # The best checkpoint may live under the ORIGINAL run's id.
        prior_best = meta.get("best_ckpt") or ""
        if prior_best and osp.exists(prior_best):
            best_ckpt = prior_best
        log.info(f"Resumed from {resume_path} at epoch {start_epoch}")

    global_step = (start_epoch - 1) * steps_per_epoch
    log_every = max(1, int(cfg.log_every_frac * steps_per_epoch))
    last_epoch = cfg.max_epochs if cfg.stop_after_epochs is None else \
        min(cfg.max_epochs, cfg.stop_after_epochs)

    def batch_of(triples):
        if is_text:
            return text_train_batch(train_data, triples)
        return transductive_train_batch(train_data, triples)

    data_axis = None if mesh is None else train_parallel.axis(mesh, "data")
    if cfg.multihost_data:
        # The per-host data path: every rank derives the same permutation
        # (Generator.permutation(n) equals shuffle(arange(n)) at equal
        # state, and LocalBatcher drops the remainder as epoch_batches
        # does) and assembles only its own rows.
        batcher = multihost.LocalBatcher(
            train_data.num_triples, cfg.batch_size,
            1 if data_axis is None else data_axis.size,
            0 if data_axis is None else data_axis.rank)

        def host_batches(epoch: int):
            for _, rows in batcher.epoch(cfg.seed * 1_000_003 + epoch):
                yield batch_of(train_data.triples[rows])

        def place(b):
            return multihost.global_batch(b, device)
    else:
        def host_batches(epoch: int):
            """One epoch of host batches; runs on the prefetch thread so the
            numpy description gathers overlap the device's work."""
            shuffle_rng = np.random.default_rng(cfg.seed * 1_000_003 + epoch)
            for triples in epoch_batches(train_data, cfg.batch_size,
                                         rng=shuffle_rng):
                yield batch_of(triples)

        def place(b):
            if mesh is None:
                return prefetch.to_device(b, device)
            return train_parallel.shard_batch(b, mesh, device)

    for epoch in range(start_epoch, last_epoch + 1):
        step_losses, t0 = [], time.time()
        for step_i, batch in enumerate(prefetch.prefetch_to_device(
                host_batches(epoch), placement=place)):
            params, opt_state, loss = train_step(
                params, opt_state, (cfg.seed, global_step), batch)
            global_step += 1
            # Losses stay on the device: a float(loss) here would wait for
            # every step. The log reads the loss of one interval ago, which
            # has long been computed, and records it under its own step.
            step_losses.append(loss)
            if step_i % log_every == 0 and step_i >= log_every:
                loss_val = float(step_losses[step_i - log_every])
                log.info(f"Epoch {epoch}/{cfg.max_epochs} "
                         f"[{step_i}/{steps_per_epoch}]: {loss_val:.6f}")
                metrics_log.log(global_step - log_every, batch_loss=loss_val)
        epoch_loss = (float(torch.stack(step_losses).mean())
                      if step_losses else 0.0)
        if step_losses and steps_per_epoch <= log_every:
            # Epochs too short for a lagged log point still log one loss.
            metrics_log.log(global_step, batch_loss=float(step_losses[-1]))
        dt = time.time() - t0
        tput = steps_per_epoch * cfg.batch_size / max(dt, 1e-9)
        metrics_log.log(epoch, train_loss=epoch_loss, triples_per_sec=tput)
        log.info(f"Epoch {epoch}: loss {epoch_loss:.6f} "
                 f"({tput:,.0f} triples/s)")

        # The full one-device state: gathered from the ranks' slices (a
        # collective), on the host.
        host_p, host_o = blp.to_device(layout.full((params, opt_state)), "cpu")
        if epoch % cfg.eval_every == 0:
            eval_params = (params if mesh is None
                           else blp.to_device(host_p, device))
            if not cfg.large_dataset:
                log.info("Evaluating on sample of training set")
                n_val_batches = -(-valid_data.num_triples // cfg.eval_batch_size)
                run_eval(eval_params, train_data.triples, train_ent,
                         prefix="train", epoch=epoch,
                         max_num_batches=n_val_batches)
            log.info("Evaluating on validation set")
            res = run_eval(eval_params, valid_data.triples, train_val_ent,
                           prefix="valid", epoch=epoch)
            del eval_params
            if res.mrr > best_mrr:
                best_mrr = res.mrr
                best_ckpt = ckpt_file
                # The model file is the user-facing artifact: stacked.
                _save(ckpt_file, training.restack_params(host_p),
                      {"epoch": epoch, "mrr": res.mrr, "run_id": run_id})
                log.info(f"New best valid MRR {best_mrr:.4f}; saved {ckpt_file}")

        # Full training state for resume, always in the stacked layout with
        # a layout marker.
        _save(state_file,
              (training.restack_params(host_p), training.restack_opt_state(host_o)),
              {"epoch": epoch, "best_mrr": best_mrr,
               "best_ckpt": best_ckpt if osp.exists(best_ckpt) else "",
               "run_id": run_id, "seed": cfg.seed, "layout": "stacked"})
        del host_p, host_o

    # ---- final filtered evaluation from best checkpoint -------------------
    params = training.restack_params(
        params if mesh is None else blp.to_device(layout.full(params), device))
    if cfg.max_epochs > 0 and osp.exists(best_ckpt):
        loaded, _ = ckpt.load_pytree(best_ckpt, template=params)
        params = blp.to_device(loaded, device)

    if cfg.large_dataset:
        filter_index = FilterIndex(valid_data.triples)
    log.info("Evaluating on validation set (with filtering)")
    run_eval(params, valid_data.triples, train_val_ent, prefix="valid",
             epoch=cfg.max_epochs + 1, filtered=True, new_entities=val_new)

    if cfg.large_dataset:
        filter_index = FilterIndex(test_data.triples)
    log.info("Evaluating on test set")
    test_res = run_eval(params, test_data.triples, train_val_test_ent,
                        prefix="test", epoch=cfg.max_epochs + 1, filtered=True,
                        new_entities=test_new, return_embeddings=True)

    emb_path = osp.join(cfg.out_dir, f"ent_emb-{run_id}.npz")
    if comm.world_rank() == 0:
        np.savez(emb_path, ent_emb=test_res.ent_emb, entities=test_res.entities)
        log.info(f"Saved entity embeddings to {emb_path}")
    return {"run_id": run_id, "test_mrr": test_res.mrr,
            "test_mrr_filt": test_res.mrr_filt, "checkpoint": ckpt_file}


def node_classification(cfg: ExperimentConfig) -> dict:
    """Frozen-embedding entity classification: a logistic-regression C sweep
    on dev, a refit on train+dev, accuracy and balanced accuracy on
    train+dev and on test. Reads the embedding export of run `checkpoint`
    in `out_dir` and the labels in `{split}-ents-class.txt`; fits on
    `device` (default cuda)."""
    device = resolve_device(cfg.device)
    ent_emb, emb_ids = load_embedding_export(cfg.out_dir, cfg.checkpoint)
    log.info(f"Loaded {len(ent_emb)} embeddings dim={ent_emb.shape[1]}")

    ent_ids, _ = load_maps(cfg.dataset_dir)
    ent2idx = make_ent2idx(emb_ids, int(emb_ids.max()))

    class2label: dict[str, int] = {}
    splits = {}
    for split in ("train", "dev", "test"):
        idx, labels = [], []
        with open(osp.join(cfg.dataset_dir, f"{split}-ents-class.txt")) as f:
            for line in f:
                entity, ent_class = line.strip().split()
                pos = int(ent2idx[ent_ids[entity]])
                if pos < 0:
                    raise ValueError(f"No embedding for entity {entity}")
                idx.append(pos)
                labels.append(class2label.setdefault(ent_class, len(class2label)))
        splits[split] = (ent_emb[idx], np.asarray(labels))

    x_train, y_train = splits["train"]
    x_dev, y_dev = splits["dev"]
    x_test, y_test = splits["test"]

    def fit(c, x, y):
        return linear_model.LogisticRegression(
            C=c, max_iter=1000, device=device).fit(x, y)

    best_acc, best_c = 0.0, 1.0
    for k in range(-4, 2):
        c = 10.0 ** -k
        acc = linear_model.accuracy_score(
            y_dev, fit(c, x_train, y_train).predict(x_dev))
        log.info(f"C={c:g} dev acc={acc:.3f}")
        if acc > best_acc:
            best_acc, best_c = acc, c

    log.info(f"Best C: {best_c:g}")
    x_all = np.concatenate([x_train, x_dev])
    y_all = np.concatenate([y_train, y_dev])
    clf = fit(best_c, x_all, y_all)

    out = {"best_c": best_c}
    for name, fn in (("accuracy", linear_model.accuracy_score),
                     ("balanced_accuracy", linear_model.balanced_accuracy_score)):
        out[f"train_{name}"] = float(fn(y_all, clf.predict(x_all)))
        out[f"test_{name}"] = float(fn(y_test, clf.predict(x_test)))
        log.info(f"Train {name}: {out[f'train_{name}']:.3f}  "
                 f"Test {name}: {out[f'test_{name}']:.3f}")

    path = osp.join(cfg.out_dir, f"classifier-{cfg.checkpoint}.npz")
    np.savez(path, coef=clf.coef_, intercept=clf.intercept_,
             classes=clf.classes_,
             id_to_class=json.dumps({v: k for k, v in class2label.items()}))
    log.info(f"Saved classifier to {path}")
    return out


COMMANDS = {"link_prediction": link_prediction,
            "node_classification": node_classification}


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"Usage: python -m blp_tpu_torch.train {{{'|'.join(COMMANDS)}}} "
              f"[with key=value ...]", file=sys.stderr)
        return 2
    cfg = parse_overrides(argv[1:])
    result = COMMANDS[argv[0]](cfg)
    # One write, so the result lines of ranks sharing a stdout stay whole.
    sys.stdout.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
