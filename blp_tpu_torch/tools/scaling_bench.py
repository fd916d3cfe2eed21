"""Scaling harness: train edges/s across mesh shapes, and the throughput of
the candidate-sharded rank pass.

The port's counterpart of the TPU package's `tools/scaling_bench.py`, with
its defaults, rows and keys. JAX drives every device from one process; here
each rank is a process, started by torch.distributed.run:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m blp_tpu_torch.tools.scaling_bench                # a card a rank (NCCL)
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m blp_tpu_torch.tools.scaling_bench --device cuda:0   # ranks share card 0 (gloo)
    python -m blp_tpu_torch.tools.scaling_bench --cpu       # a world of one, on the CPU

Without the launcher it runs as a world of one. With W ranks it measures:
- (1, 1) on rank 0 alone, through the one-device paths
  (`training.make_train_step`, K1 through
  `ops/transe_rank.transe_tiled_rank_counts`), while the other ranks wait
  at a barrier, so no rank sits in a collective meanwhile;
- (W, 1) when W >= 2 and (W/2, 2) when W >= 4 and even, over a mesh of the
  whole world (`parallel/mesh.make_mesh`, `parallel/train_parallel`, and
  `parallel/eval_parallel.rank_counts`, K1 on each rank's block).
Training: tiny BERT (4 heads), dim 16, B `--batch` (256), L 16, K 8, 2
warm-up and 10 timed steps. Evaluation: N 131,072, d 128, B 32, tile 4,096,
8 filter slots of -1, 5 timed passes. Inputs come from numpy (seed 0).

Where the ranks share one device (the CPU, or a named card under gloo), they
share its FLOPs: the rows then carry `virtual_mesh_overhead_vs_1dev` and the
TPU tool's note, as its virtual CPU mesh does; with a card a rank they carry
`efficiency_vs_1dev = tput / (base * n_dev)`. Only rank 0 prints; on the card
each row adds the card's name, power limit and rank 0's peak memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

NOTE = ("virtual mesh shares one host's FLOPs; validates semantics/overhead, "
        "not scaling")


def measure_train(mesh_shape, B, device, steps=10, L=16, K=8) -> float:
    """Train edges/s at `mesh_shape`; (1, 1) runs the one-device step."""
    import torch

    from blp_tpu_torch import training
    from blp_tpu_torch.data import prefetch
    from blp_tpu_torch.models import bert, blp
    from blp_tpu_torch.parallel import mesh as mesh_lib
    from blp_tpu_torch.parallel import train_parallel

    enc = bert.BertConfig.tiny(num_heads=4)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                          dim=16, num_relations=8, encoder=enc)
    params = blp.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    optimizer = training.make_optimizer(1e-4, 10_000)
    rng = np.random.default_rng(0)
    host = {"text_tok": rng.integers(1, enc.vocab_size, (B, 2, L)),
            "text_mask": np.ones((B, 2, L), np.float32),
            "rels": rng.integers(0, 8, (B,)).astype(np.int32)}
    if mesh_shape == (1, 1):
        opt_state = optimizer.init(params)
        step = training.make_train_step(cfg, optimizer, batch_size=B,
                                        num_negatives=K, device=device)
        batch = prefetch.to_device(host, device)
    else:
        mesh = mesh_lib.make_mesh(*mesh_shape, device=device)
        params, opt_state, _ = train_parallel.init_parallel_state(
            params, optimizer, mesh, tensor_parallel=mesh_shape[1] > 1)
        step = train_parallel.make_parallel_train_step(
            cfg, optimizer, mesh=mesh, batch_size=B, num_negatives=K,
            device=device)
        batch = train_parallel.shard_batch(host, mesh, device)

    for n in range(2):
        params, opt_state, loss = step(params, opt_state, (0, n), batch)
    float(loss)
    t0 = time.perf_counter()
    for n in range(2, 2 + steps):
        params, opt_state, loss = step(params, opt_state, (0, n), batch)
    float(loss)     # depends on every step before it
    return B / ((time.perf_counter() - t0) / steps)


def measure_eval(mesh_shape, device, N=131072, d=128, B=32, tile=4096,
                 reps=5) -> float:
    """Candidate scores/s of the TransE head-corruption rank pass over an
    (N, d) table split over `mesh_shape`; (1, 1) runs K1 on one device."""
    import torch

    from blp_tpu_torch.ops import transe_rank
    from blp_tpu_torch.parallel import eval_parallel
    from blp_tpu_torch.parallel import mesh as mesh_lib

    n_dev = mesh_shape[0] * mesh_shape[1]
    Np = -(-N // (tile * n_dev)) * tile * n_dev
    rng = np.random.default_rng(0)
    table = rng.standard_normal((Np, d)).astype(np.float32)

    def on_dev(a):
        return torch.from_numpy(a).to(device)

    fixed = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    rel = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    true_pos = on_dev(rng.integers(0, N, B).astype(np.int32))
    filt = torch.full((B, 8), -1, dtype=torch.int32, device=device)
    if mesh_shape == (1, 1):
        whole = on_dev(table)

        def fn():
            return transe_rank.transe_tiled_rank_counts(
                whole, fixed, rel, None, true_pos, filt, N, corrupt="head")
    else:
        shard = eval_parallel.Shard.of(
            mesh_lib.make_mesh(*mesh_shape, device=device), Np)
        block = on_dev(table[shard.offset:shard.offset + shard.rows])

        def fn():
            return eval_parallel.rank_counts(
                shard, block, fixed, rel, true_pos, filt, N,
                rel_model="transe", corrupt="head", tile=tile)
    del table
    int(fn()["gt"][0])
    t0 = time.perf_counter()
    for _ in range(reps):
        c = fn()
    int(c["gt"][0])     # a host read waits for every pass queued before
    return B * N / ((time.perf_counter() - t0) / reps)


def main(argv: list[str] | None = None, *, eval_n: int = 131072) -> list[dict]:
    """Run the harness on every rank of the world (joined here from
    torch.distributed.run's environment, or already joined by the caller);
    returns the rows on rank 0 and [] on the others. `eval_n` (the
    evaluation's candidates) lets a test run a small table; the command
    runs the TPU tool's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help='"cuda": a card a rank (NCCL); a named card such as '
                         '"cuda:0": every rank on it (gloo)')
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (device=cpu)")
    args = ap.parse_args(argv)

    import torch

    from blp_tpu_torch.parallel import comm
    from blp_tpu_torch.utils import card_stats, resolve_device

    device = "cpu" if args.cpu else args.device
    resolve_device(device)
    dev = comm.init_world(device)
    world, rank = comm.world_size(), comm.world_rank()
    shapes = [(1, 1)]
    if world >= 2:
        shapes += [(world, 1)]
    if world >= 4 and world % 2 == 0:
        shapes += [(world // 2, 2)]
    # Ranks on one device share its FLOPs: per-device efficiency is not
    # measurable there, and the honest metric is the partitioning overhead
    # (perfect behaviour keeps the throughput equal to the one-device run).
    virtual = dev.type == "cpu" or (world > 1 and comm.backend_for(device) == "gloo")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def alone(fn):
        """fn() on rank 0 while the other ranks wait at a barrier."""
        out = fn() if rank == 0 else None
        comm.barrier()
        return out

    rows = []

    def report(bench, shape, tput, base, unit):
        if rank:
            return
        n_dev = shape[0] * shape[1]
        row = {"bench": bench, "mesh": list(shape), unit: round(tput, 1)}
        if virtual:
            row["virtual_mesh_overhead_vs_1dev"] = round(tput / base, 3)
            row["note"] = NOTE
        else:
            row["efficiency_vs_1dev"] = round(tput / (base * n_dev), 3)
        row.update(card_stats(dev))
        print(json.dumps(row), flush=True)
        rows.append(row)

    base = alone(lambda: measure_train((1, 1), args.batch, dev))
    report("train", (1, 1), base, base, "edges_per_sec")
    for shape in shapes[1:]:
        report("train", shape, measure_train(shape, args.batch, dev), base,
               "edges_per_sec")
    base = alone(lambda: measure_eval((1, 1), dev, N=eval_n))
    report("eval_rank", (1, 1), base, base, "cand_scores_per_sec")
    for shape in shapes[1:]:
        report("eval_rank", shape, measure_eval(shape, dev, N=eval_n), base,
               "cand_scores_per_sec")
    return rows


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
