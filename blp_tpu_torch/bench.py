"""Benchmark: flagship training throughput on the card.

The port's counterpart of the TPU package's root `bench.py`:

    python -m blp_tpu_torch.bench            # the flagship point
    python -m blp_tpu_torch.bench --w5m      # the Wikidata5M training point

Prints the window times on stderr and ONE JSON line: {"metric": ...,
"value": N, "unit": ..., "vs_baseline": N}, plus, on the card, its name,
power limit and peak memory.

Workload: the BLP flagship hot path, a BERT-base encoder (bf16 compute)
over 2B = 256 descriptions of 32 tokens, TransE scores of the positives and
64 in-batch negatives sampled on the device, the margin loss and an Adam
step (f32 state, lr 2e-5 with warmup over 10,000 steps), at fixed shapes,
remat off and 32-bit dropout masks. `--w5m` is the Wikidata5M training point
(scripts/blp-transe-wikidata5m.sh: B 1,024, max_len 64, K 64) at the TPU
bench's settings: partial remat of 4 layers, fast_train and 8-bit dropout
masks. 6 warm-up steps, then 3 windows of 20 steps (10 at --w5m); each
window ends with one host read of the last loss, which depends on every
step before it, and the fastest window is kept. `vs_baseline` divides by
bench_baseline_torch.json's value (the reference's step on the card,
tools/measure_reference_baseline.py) where that file exists, else 0.0, and
is 0.0 at --w5m, as in the TPU bench.

Like the TPU bench, this entry point keeps `sddmm_pallas` (K3) and
`fused_attention` (K2) off and does not rank; on the card its BERT layers
run F1 and F2 (ops/fused_layer.py), the kernels of the chains XLA fuses in
the TPU package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from blp_tpu_torch import training
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.utils import card_stats, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "bench_baseline_torch.json")

#: (B, L, K), (steps, warmup, windows) and the encoder's training settings.
FLAGSHIP = dict(shape=(128, 32, 64), timing=(20, 6, 3),
                encoder=dict(remat=False, dropout_bits=32, fast_train=False))
W5M = dict(shape=(1024, 64, 64), timing=(10, 6, 3),
           encoder=dict(remat=4, dropout_bits=8, fast_train=True))
LR, TOTAL_STEPS = 2e-5, 10_000


def model_config(point: dict, encoder: bert.BertConfig | None = None) -> blp.ModelConfig:
    """BLP-TransE at dim 128 over 16 relations; `encoder` (default BERT-base
    in bf16) takes the point's training settings."""
    enc = encoder or bert.BertConfig(compute_dtype=torch.bfloat16)
    enc = dataclasses.replace(enc, **point["encoder"])
    return blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                           dim=128, num_relations=16, encoder=enc)


def setup(B: int, L: int, K: int, cfg: blp.ModelConfig, device):
    """(step, params, opt_state, batch) of the train step at (B, L, K):
    parameters from seed 0 and one numpy batch (seed 0)."""
    dev = resolve_device(device)
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device=dev))
    optimizer = training.make_optimizer(LR, TOTAL_STEPS)
    opt_state = optimizer.init(params)
    step = training.make_train_step(cfg, optimizer, batch_size=B,
                                    num_negatives=K, device=dev)
    rng = np.random.default_rng(0)
    batch = {
        "text_tok": torch.from_numpy(
            rng.integers(1, cfg.encoder.vocab_size, (B, 2, L))).to(dev),
        "text_mask": torch.ones((B, 2, L), device=dev),
        "rels": torch.from_numpy(rng.integers(0, 16, (B,))).to(dev),
    }
    return step, params, opt_state, batch


def measure(B: int, L: int, K: int, steps: int, warmup: int, windows: int,
            cfg: blp.ModelConfig, device) -> list[float]:
    """Seconds a step of each timed window of the train step at (B, L, K)
    (see `setup`), the same batch every step."""
    step, params, opt_state, batch = setup(B, L, K, cfg, device)
    return time_windows(step, params, opt_state, batch, steps=steps,
                        warmup=warmup, windows=windows)


def time_windows(step, params, opt_state, batch, *, steps: int, warmup: int,
                 windows: int) -> list[float]:
    """`warmup` steps, then seconds a step of each of `windows` windows of
    `steps` steps, each ending in one host read of the last loss, which
    depends on every step before it. Step keys are (0, global step)."""
    n = 0
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, (0, n), batch)
        n += 1
    float(loss)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, (0, n), batch)
            n += 1
        float(loss)
        times.append((time.perf_counter() - t0) / steps)
    return times


def report(B: int, times: list[float], *, w5m: bool,
           baseline: str = BASELINE) -> dict:
    """bench.py's JSON line from the window times: triples/s of the fastest
    window, and vs_baseline against `baseline` (0.0 at the W5M point or
    without the file)."""
    tput = B / min(times)
    vs = 0.0
    if not w5m and os.path.exists(baseline):
        with open(baseline) as f:
            vs = tput / json.load(f)["value"]
    return {"metric": "train_triples_per_sec_w5m" if w5m else "train_triples_per_sec",
            "value": round(tput, 2), "unit": "triples/s",
            "vs_baseline": round(vs, 2)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--w5m", action="store_true",
                    help="the Wikidata5M training point (B 1,024, L 64)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    point = W5M if args.w5m else FLAGSHIP
    (B, L, K), (steps, warmup, windows) = point["shape"], point["timing"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = measure(B, L, K, steps, warmup, windows, model_config(point), dev)
    print(f"windows ms/step: {[round(t * 1e3, 1) for t in times]}",
          file=sys.stderr)
    out = {**report(B, times, w5m=args.w5m), **card_stats(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
