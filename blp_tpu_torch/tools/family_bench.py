"""Train-step throughput across the model family, one JSON line each.

The port's counterpart of the TPU package's `tools/family_bench.py`, with
its table of families, flags and JSON keys. The method is the bench's
(blp_tpu_torch/bench.py `time_windows`): the train step with negatives
sampled on the device, Adam in f32 at lr 2e-5 with warmup, 6 warm-up steps,
then 3 windows of `--reps` steps, the fastest window kept. Like the TPU tool it keeps K3 (`sddmm_pallas`) off.

    python -m blp_tpu_torch.tools.family_bench            # all families
    python -m blp_tpu_torch.tools.family_bench --models blp glove-bow

The batches come from numpy (seed 0). On the card each line adds the
card's name, power limit and peak memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

FAMILIES = {
    # model: (batch, max_len, dim, emb_dim, vocab)
    "glove-bow": (4096, 32, 300, 300, 40_000),
    "bert-bow": (4096, 32, 768, 768, 28_996),
    "glove-dkrl": (2048, 32, 128, 300, 40_000),
    "bert-dkrl": (2048, 32, 128, 768, 28_996),
    "transductive": (4096, 0, 128, 0, 0),
    "blp": (128, 32, 128, 0, 0),
    # The Wikidata5M training point (scripts/blp-transe-wikidata5m.sh: B
    # 1,024, max_len 64, K 64, bf16) at the bench's --w5m settings: partial
    # remat of 4 layers, fast_train and 8-bit dropout masks.
    "blp-w5m": (1024, 64, 128, 0, 0),
}


def bench_family(model: str, *, reps: int = 15, families: dict = FAMILIES,
                 encoder=None, device=None) -> dict:
    """One family's line. `families` and `encoder` (in place of BERT-base
    in bf16 for the blp rows) let a test run small widths."""
    import torch

    from blp_tpu_torch import training
    from blp_tpu_torch.bench import time_windows
    from blp_tpu_torch.models import bert, blp
    from blp_tpu_torch.utils import card_stats, resolve_device

    dev = resolve_device(device)
    B, L, dim, emb_dim, vocab = families[model]
    K = 64
    kw = dict(model="blp" if model.startswith("blp") else model,
              rel_model="transe", loss_fn="margin", dim=dim,
              num_relations=16)
    if model.startswith("blp"):
        w5m = model == "blp-w5m"
        enc = encoder or bert.BertConfig(compute_dtype=torch.bfloat16)
        cfg = blp.ModelConfig(**kw, encoder=dataclasses.replace(
            enc, remat=4 if w5m else False, dropout_bits=8 if w5m else 32,
            fast_train=w5m))
    elif model == "transductive":
        cfg = blp.ModelConfig(**kw, num_entities=40_000)
    else:
        cfg = blp.ModelConfig(**kw, emb_dim=emb_dim, vocab_size=vocab)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device=dev))
    opt = training.make_optimizer(2e-5, 10_000)
    step = training.make_train_step(cfg, opt, batch_size=B, num_negatives=K,
                                    device=dev)
    rng = np.random.default_rng(0)
    if model == "transductive":
        host = {"pos_pairs": rng.integers(0, 40_000, (B, 2)),
                "rels": rng.integers(0, 16, (B,))}
    else:
        V = cfg.encoder.vocab_size if model.startswith("blp") else vocab
        host = {"text_tok": rng.integers(1, V, (B, 2, L)),
                "text_mask": np.ones((B, 2, L), np.float32),
                "rels": rng.integers(0, 16, (B,))}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    best = min(time_windows(step, params, opt.init(params), batch, steps=reps,
                            warmup=6, windows=3))
    return {"model": model, "batch": B, "num_negatives": K,
            "ms_per_step": round(best * 1e3, 1),
            "triples_per_sec": round(B / best, 1), **card_stats(dev)}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=list(FAMILIES))
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    args = ap.parse_args(argv)
    rows = []
    for model in args.models:
        row = bench_family(model, reps=args.reps,
                           device="cpu" if args.cpu else None)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
