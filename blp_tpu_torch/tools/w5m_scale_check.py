"""Wikidata5M-scale streaming check: rank against millions of candidates.

The port's counterpart of the TPU package's `tools/w5m_scale_check.py`, with
its flags, defaults and JSON keys. It holds that the streamed rank counts
(`ops/ranking.tiled_rank_counts`, the plain PyTorch stream that serves the
bilinear scorers and cross-checks K1) keep their memory at O(B * tile)
whatever the candidate count, and reports the rank pass's time. With
`--bidir` it also times the fused both-direction stream
(`tiled_rank_counts_bidir`) against two one-direction passes.

    python -m blp_tpu_torch.tools.w5m_scale_check --n 4800000 --bidir
    python -m blp_tpu_torch.tools.w5m_scale_check --n 20000 --tile 4096 --cpu

The inputs come from numpy (seed 0), as the TPU tool's. Prints one JSON
line; on the card it adds the card's name, power limit and peak memory.
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
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tile", type=int, default=65536)
    ap.add_argument("--rel-model", default="transe")
    ap.add_argument("--bidir", action="store_true",
                    help="A/B the fused both-direction stream against two "
                         "unidirectional passes")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    import torch

    from blp_tpu_torch.ops import ranking
    from blp_tpu_torch.utils import card_stats, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    N, d, B, tile = args.n, args.d, args.batch, args.tile
    Np = -(-N // tile) * tile
    rng = np.random.default_rng(0)
    rm = args.rel_model

    def on_dev(a):
        return torch.from_numpy(a).to(device)

    def force(counts: dict, key: str) -> None:
        int(counts[key][0])   # a host read waits for every call queued before

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    table = on_dev(rng.standard_normal((Np, d)).astype(np.float32))
    fixed = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    rel = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    true_pos = on_dev(rng.integers(0, N, B).astype(np.int32))
    filt = torch.full((B, 64), -1, dtype=torch.int32, device=device)
    ts = ranking.score_pairs(table[true_pos.long()], fixed, rel, rel_model=rm,
                             corrupt="head")[:, None]

    def one_pass():
        return ranking.tiled_rank_counts(table, fixed, rel, ts, true_pos, filt,
                                         N, rel_model=rm, corrupt="head",
                                         tile=tile)

    force(one_pass(), "gt")
    setup = time.time() - t0

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        c = one_pass()
    force(c, "gt")
    dt = (time.time() - t0) / reps

    out = {
        "n_candidates": N, "batch": B, "tile": tile, "rel_model": rm,
        "table_gb": round(Np * d * 4 / 2**30, 2),
        "setup_s": round(setup, 1),
        "rank_pass_s": round(dt, 3),
        "cand_scores_per_sec": round(B * N / dt / 1e6, 1),
        "unit": "M scores/s",
    }

    if args.bidir:
        head_emb = table[true_pos.long()]
        tail_pos = on_dev(rng.integers(0, N, B).astype(np.int32))
        tail_emb = table[tail_pos.long()]
        h_ts = ranking.score_pairs(head_emb, tail_emb, rel, rel_model=rm,
                                   corrupt="head")[:, None]
        t_ts = ranking.score_pairs(tail_emb, head_emb, rel, rel_model=rm,
                                   corrupt="tail")[:, None]

        def two_pass():
            a = ranking.tiled_rank_counts(
                table, tail_emb, rel, h_ts, true_pos, filt, N, rel_model=rm,
                corrupt="head", tile=tile)
            b2 = ranking.tiled_rank_counts(
                table, head_emb, rel, t_ts, tail_pos, filt, N, rel_model=rm,
                corrupt="tail", tile=tile)
            return a, b2

        def fused():
            return ranking.tiled_rank_counts_bidir(
                table, head_emb, tail_emb, rel, h_ts, t_ts, true_pos,
                tail_pos, filt, filt, N, rel_model=rm, tile=tile)

        a, b2 = two_pass()
        force(b2, "gt")
        t0 = time.time()
        for _ in range(reps):
            a, b2 = two_pass()
        force(b2, "gt")
        dt_two = (time.time() - t0) / reps

        f = fused()
        force(f, "h_gt")
        t0 = time.time()
        for _ in range(reps):
            f = fused()
        force(f, "h_gt")
        dt_fused = (time.time() - t0) / reps

        # The stacked (2B, d) matmul of the bilinear scorers need not equal
        # two (B, d) matmuls bit for bit; count mismatches (ties flipped at
        # the last bit) rather than assert in a measuring tool.
        mism = int((~np.isclose(f["h_gt"].cpu().numpy(), a["gt"].cpu().numpy(),
                                atol=1)).sum()
                   + (~np.isclose(f["t_gt"].cpu().numpy(),
                                  b2["gt"].cpu().numpy(), atol=1)).sum())
        out["fused_vs_two_pass_count_mismatches"] = mism
        out.update({
            "both_dir_two_pass_s": round(dt_two, 3),
            "both_dir_fused_s": round(dt_fused, 3),
            "fused_speedup": round(dt_two / dt_fused, 2),
        })

    out.update(card_stats(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
