"""Serving-path latency: streaming top-k queries over a large candidate
table (serve.py LinkPredictor -> ops/ranking top-k).

The port's counterpart of the TPU package's `tools/serving_bench.py`, with
its flags, defaults and JSON keys. It measures per-query-batch latency
(p50/p95 over repeated calls after a warm-up call; `predict_tails` copies
its answer to the host, so each call ends in a sync) for several batch
sizes. `--approx` is accepted and selects exactly, as `ops/ranking`'s top-k
does.

    python -m blp_tpu_torch.tools.serving_bench --n 4800000 --rel-model transe
    python -m blp_tpu_torch.tools.serving_bench --n 5000 --batches 1 8 --cpu

The table and queries come from numpy (seed 0) in the TPU tool's order.
Prints one JSON line a batch; on the card each adds the card's name, power
limit and peak memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv: list[str] | None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tile", type=int, default=65536)
    ap.add_argument("--rel-model", default="transe")
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 8, 64])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--approx", action="store_true",
                    help="accepted for the TPU tool's flags; selection is exact")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    return ap.parse_args(argv)


def draw_inputs(n: int, d: int, batches: list[int]):
    """The TPU tool's seed-0 draws in its order: the (n, d) candidate table,
    then (B, embeddings (B, d), relations (B,)) for each batch size."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n, d)).astype(np.float32)
    queries = [(b, rng.standard_normal((b, d)).astype(np.float32),
                rng.integers(0, 64, b)) for b in batches]
    return table, queries


def make_server(args, params=None, device=None):
    """The tool's LinkPredictor: a BLP model over `BertConfig.tiny()` (64
    relations, dim `args.d`) with `params` (random from seed 0 when None),
    and no candidates yet."""
    import torch

    from blp_tpu_torch.models import bert, blp
    from blp_tpu_torch.serve import LinkPredictor

    cfg = blp.ModelConfig(model="blp", rel_model=args.rel_model,
                          loss_fn="margin", dim=args.d, num_relations=64,
                          encoder=bert.BertConfig.tiny())
    if params is None:
        params = blp.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=device)
    return LinkPredictor(params=params, cfg=cfg, tile=args.tile,
                         approx=args.approx, device=device)


def main(argv: list[str] | None = None, *, params=None) -> list[dict]:
    """Run the tool; `params` are the model's weights (random from seed 0
    when None). Returns the printed rows."""
    args = parse_args(argv)

    import torch

    from blp_tpu_torch.utils import card_stats, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    srv = make_server(args, params, device)
    table, queries = draw_inputs(args.n, args.d, args.batches)
    srv.set_candidates(table, np.arange(args.n))

    rows = []
    for B, emb, rels in queries:
        srv.predict_tails(head_emb=emb, rels=rels, k=args.k)   # warm-up
        lat = []
        for _ in range(args.reps):
            t0 = time.time()
            srv.predict_tails(head_emb=emb, rels=rels, k=args.k)
            lat.append((time.time() - t0) * 1e3)
        lat = np.sort(np.asarray(lat))
        row = {
            "metric": "serving_topk_latency_ms", "batch": B,
            "n_candidates": args.n, "k": args.k,
            "rel_model": args.rel_model, "approx": args.approx,
            "p50": round(float(np.percentile(lat, 50)), 2),
            "p95": round(float(np.percentile(lat, 95)), 2),
            "qps": round(B / (np.median(lat) / 1e3), 1),
            **card_stats(device),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
