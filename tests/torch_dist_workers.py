"""Spawned gloo worlds on the CPU for the port's multi-rank tests.

`run_world(fn, world, tmp_path, *args)` starts `world` processes, each a
rank of a gloo world on the CPU (one thread, its own file:// rendezvous
under tmp_path), calls fn(rank, *args) in each and returns the ranks'
return values in rank order; `device="cuda:0"` puts every rank on the card
instead (tests/test_torch_cuda.py). The workers live here, in a module that
imports neither jax nor blp_tpu: spawned processes unpickle their target by
module, and the port must run without either.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from blp_tpu_torch import training
from blp_tpu_torch.checkpoint import tree_leaves
from blp_tpu_torch.models import blp
from blp_tpu_torch.ops import transe_rank
from blp_tpu_torch.parallel import comm
from blp_tpu_torch.parallel import mesh as mesh_lib
from blp_tpu_torch.parallel import train_parallel

#: Seconds a world may take before the test fails (and its ranks are killed).
TIMEOUT = 240


def _entry(rank, fn, world, store, out_dir, args, device):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.pop("WORLD_SIZE", None)
    comm.init_world(device, init_method=f"file://{store}", world_size=world,
                    rank=rank)
    result = fn(rank, *args)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn, world: int, tmp_path, *args, device="cpu") -> list:
    out_dir = os.path.join(str(tmp_path), f"world{world}-{time.monotonic_ns()}")
    os.makedirs(out_dir)
    ctx = mp.start_processes(_entry, args=(fn, world, os.path.join(out_dir, "store"),
                                           out_dir, args, device),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"world of {world} ranks ran past {TIMEOUT} s")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def numpy_tree(tree):
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


# -- parallel/train_parallel.py ----------------------------------------------

def parallel_steps(rank: int, cases: list) -> list:
    """One step of each case on its (data, model) mesh over this world.

    A case: mesh (D, M), cfg, params (the TPU package's tree, numpy), batch
    (numpy, whole), and either neg (injected negatives; one Adam step from
    parallel_value_and_grad) or key (make_parallel_train_step); device
    (default cpu). Returns, per case, the loss, the gathered full parameters
    after the step (stacked, JAX leaf order), the gathered gradients, and
    this rank's leaf shapes."""
    out = []
    for case in cases:
        dev = torch.device(case.get("device", "cpu"))
        d, m = case["mesh"]
        mesh = mesh_lib.make_mesh(d, m, device=dev)
        cfg = case["cfg"]
        opt = training.make_optimizer(1e-3, 10, use_scheduler=False)
        full = blp.to_device(training.unstack_params(
            blp.params_from_jax(case["params"])), dev)
        params, opt_state, split = train_parallel.init_parallel_state(
            full, opt, mesh, tensor_parallel=m > 1)
        data = train_parallel.axis(mesh, "data")
        model = train_parallel.model_axis(mesh)
        batch = {k: torch.from_numpy(v[train_parallel.local_rows(len(v), data)]).to(dev)
                 for k, v in case["batch"].items()}
        b = len(case["batch"]["rels"])
        res = {"shapes": {k: tuple(v.shape) for k, v in
                          params["bert"]["layers"][0].items()}}
        if "neg" in case:
            nb = {**batch, "neg_idx": torch.from_numpy(case["neg"]).to(dev)}
            loss, grads = train_parallel.parallel_value_and_grad(
                params, cfg, nb, dropout_seed=0, data=data, model=model)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = training.apply_updates(params, updates)
            g = train_parallel.gather_state(grads, mesh, split)
            res["grads"] = numpy_tree(training.restack_params(g))
        else:
            step = train_parallel.make_parallel_train_step(
                cfg, opt, mesh=mesh, batch_size=b,
                num_negatives=case["k"], device=dev)
            params, opt_state, loss = step(params, opt_state, case["key"], batch)
        res["loss"] = float(loss)
        full_p = train_parallel.gather_state(params, mesh, split)
        res["params"] = numpy_tree(training.restack_params(full_p))
        out.append(res)
    return out


# -- parallel/multihost.py ----------------------------------------------------

def local_batches(rank: int, num_edges: int, global_batch_size: int,
                  seed: int) -> list:
    """Every global batch of an epoch, assembled from each rank's
    LocalBatcher rows through global_batch and an all_gather."""
    from blp_tpu_torch.parallel import multihost

    batcher = multihost.LocalBatcher(num_edges, global_batch_size,
                                     comm.world_size(), rank)
    out = []
    for _, rows in batcher.epoch(seed):
        local = multihost.global_batch({"rows": rows}, "cpu")["rows"]
        out.append(torch.cat(comm.all_gather(local)).numpy())
    return out


# -- parallel/eval_parallel.py and evaluation.py's mesh path -----------------

def mesh_evals(rank: int, data_dir: str, cases: list) -> list:
    """eval_link_prediction(mesh=...) for each case on the dev triples of the
    synthetic graph at data_dir: (mesh shape, cfg, params as the TPU
    package's numpy tree, keyword arguments). Returns per case the result's
    scalars and the whole table (return_embeddings)."""
    from blp_tpu_torch import evaluation
    from blp_tpu_torch.data.datasets import GraphData, TextGraphData
    from blp_tpu_torch.data.filtering import FilterIndex
    from blp_tpu_torch.data.tokenizers import WordPieceTokenizer

    train = TextGraphData.load(f"{data_dir}/ind-train.tsv", max_len=16,
                               tokenizer=WordPieceTokenizer(f"{data_dir}/vocab.txt"))
    dev = GraphData.load(f"{data_dir}/ind-dev.tsv")
    test = GraphData.load(f"{data_dir}/ind-test.tsv")
    fidx = FilterIndex(np.concatenate([train.triples, dev.triples, test.triples]))
    entities = np.unique(np.concatenate([train.entities, dev.entities]))
    out = []
    for shape, cfg, params, kw in cases:
        device = kw.pop("device", "cpu")
        mesh = mesh_lib.make_mesh(*shape, device=device)
        res = evaluation.eval_link_prediction(
            blp.to_device(blp.params_from_jax(params), device), cfg,
            dev.triples, train, entities, filter_index=fidx,
            return_embeddings=True, mesh=mesh, device=device, **kw)
        out.append({"scalars": res.scalars("x"), "table": res.ent_emb,
                    "k1_by_variant": dict(transe_rank.launches_by_variant)})
    return out


# -- parallel/pipeline.py -------------------------------------------------------

def pipeline_runs(rank: int, cases: list) -> list:
    """For each case on its (data, pipe) mesh: the loss and the gathered
    full gradients (JAX leaf order) of pipeline_value_and_grad with the
    injected `neg` (dropout off) or with `dropout_seed`; or, with `key`, the
    loss and full parameters after one make_pipeline_train_step."""
    from blp_tpu_torch.parallel import pipeline

    out = []
    for case in cases:
        dev = torch.device(case.get("device", "cpu"))
        d, p = case["mesh"]
        mesh = pipeline.make_pipeline_mesh(d, p, device=dev)
        cfg = case["cfg"]
        full = blp.to_device(blp.params_from_jax(case["params"]), dev)
        params = pipeline.shard_pipeline_params(full, mesh)
        data = train_parallel.axis(mesh, "data")
        batch = {k: torch.from_numpy(np.array(v[train_parallel.local_rows(len(v), data)])).to(dev)
                 for k, v in case["batch"].items()}
        res = {"layers": tuple(params["bert"]["layers"]["q_w"].shape)}
        if "key" in case:
            opt = training.make_optimizer(1e-3, 10, use_scheduler=False)
            step = pipeline.make_pipeline_train_step(
                cfg, opt, mesh=mesh, batch_size=len(case["batch"]["rels"]),
                num_negatives=case["k"], num_microbatches=case["micro"],
                device=dev)
            params, _, loss = step(params, opt.init(params), case["key"], batch)
            res["params"] = numpy_tree(pipeline.gather_pipeline_params(params, mesh))
        else:
            batch["neg_idx"] = torch.from_numpy(case["neg"]).to(dev)
            loss, grads = pipeline.pipeline_value_and_grad(
                params, cfg, batch, mesh=mesh, num_microbatches=case["micro"],
                dropout_seed=case.get("dropout_seed"))
            res["grads"] = numpy_tree(pipeline.gather_pipeline_params(grads, mesh))
        res["loss"] = float(loss)
        out.append(res)
    return out


# -- train.py's link_prediction over a mesh -----------------------------------

def link_prediction_runs(rank: int, configs: list, raising=()) -> list:
    """train.link_prediction for each ExperimentConfig in this world: its
    result, or, for a run_id in `raising`, the message of the ValueError it
    raised."""
    from blp_tpu_torch import train

    out = []
    for cfg in configs:
        if cfg.run_id not in raising:
            out.append(train.link_prediction(cfg))
            continue
        try:
            train.link_prediction(cfg)
        except ValueError as e:
            out.append({"error": str(e)})
        else:
            out.append({"error": None})
    return out


# -- eval_parallel.rank_counts and tools/scaling_bench.py ---------------------

def sharded_counts_and_scaling(rank: int, cases: list, scaling_argv: list,
                               eval_n: int) -> dict:
    """eval_parallel.rank_counts for each case over a (world, 1) mesh (the
    case's whole numpy table on every rank, each rank counting its block),
    then scaling_bench.main(scaling_argv, eval_n=eval_n) in the same world:
    the counts as numpy, and the rows (rank 0's; [] on the others)."""
    from blp_tpu_torch.parallel import eval_parallel
    from blp_tpu_torch.tools import scaling_bench

    mesh = mesh_lib.make_mesh(comm.world_size(), 1, device="cpu")
    counts = []
    for case in cases:
        shard = eval_parallel.Shard.of(mesh, len(case["table"]))
        block = torch.from_numpy(case["table"][shard.offset:shard.offset + shard.rows])
        c = eval_parallel.rank_counts(
            shard, block, *(torch.from_numpy(case[k]) for k in
                            ("fixed", "rel", "true_pos", "filter_pos")),
            case["n"], rel_model=case["rel_model"], corrupt=case["corrupt"],
            tile=case["tile"])
        counts.append({k: v.numpy() for k, v in c.items()})
    return {"counts": counts,
            "rows": scaling_bench.main(scaling_argv, eval_n=eval_n)}
