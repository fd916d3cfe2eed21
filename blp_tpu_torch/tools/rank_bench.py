"""A/B: K1, the TransE rank-count kernel, against the plain both-direction
stream at Wikidata5M scale.

The port's counterpart of the TPU package's `tools/pallas_rank_bench.py`,
with its inputs, defaults and printed lines. It times the plain stream
(`ops/ranking.tiled_rank_counts_bidir`, at `--xla-tile`, the flag's name
kept so commands carry over) and then K1 through
`ops/transe_rank.transe_tiled_rank_counts_bidir`, and counts the entries
more than 1 apart, as the TPU tool does. The two add each distance in
another fp32 order, and over millions of candidates the near-ties of a
query's pivot move an entry by more than 1; so it also counts the entries
that differ by more than the candidates within the fp32 rounding bound of
the pivot (two more plain passes), which must be none. The TPU tool's
`--tiles` is gone: the CUDA kernel's grid is persistent and takes no
tile, so the flag would select nothing. On the CPU (`--cpu`) K1's path runs
the kernel's plain version.

    python -m blp_tpu_torch.tools.rank_bench
    python -m blp_tpu_torch.tools.rank_bench --n 20000 --b 8 --xla-tile 4096 --cpu

The inputs come from numpy (seed 0) in the TPU tool's order. Prints the
TPU tool's lines and the rounding-band line, then one JSON line with both
times, both counts and, on the card, its name, power limit and peak memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4_800_000)
    p.add_argument("--b", type=int, default=64)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--f", type=int, default=64)
    p.add_argument("--xla-tile", type=int, default=65536,
                   help="tile of the plain stream")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device=cpu); the default is cuda")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    import torch

    from blp_tpu_torch.ops import ranking, transe_rank
    from blp_tpu_torch.utils import card_stats, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    N, B, d, F = args.n, args.b, args.d, args.f
    Np = -(-N // 65536) * 65536
    rng = np.random.default_rng(0)
    print(f"N={N:,} Np={Np:,} B={B} d={d} F={F}")

    def on_dev(a):
        return torch.from_numpy(a).to(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    table = on_dev(rng.standard_normal((Np, d)).astype(np.float32))
    head = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    tail = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    rel = on_dev(rng.standard_normal((B, d)).astype(np.float32))
    head_pos = on_dev(rng.integers(0, N, B).astype(np.int32))
    tail_pos = on_dev(rng.integers(0, N, B).astype(np.int32))
    hf = on_dev(rng.integers(0, N, (B, F)).astype(np.int32))
    tf = on_dev(rng.integers(0, N, (B, F)).astype(np.int32))

    h_true = ranking.score_pairs(table[head_pos.long()], tail, rel,
                                 rel_model="transe", corrupt="head")[:, None]
    t_true = ranking.score_pairs(table[tail_pos.long()], head, rel,
                                 rel_model="transe", corrupt="tail")[:, None]

    def timeit(fn, label):
        out = fn()
        sum(int(v.sum()) for v in out.values())   # a host read waits for the call
        t0 = time.time()
        for _ in range(args.reps):
            out = fn()
        checksum = sum(int(v.sum()) for v in out.values())
        dt = (time.time() - t0) / args.reps * 1e3
        print(f"{label:44s} {dt:8.1f} ms  (checksum {checksum})")
        return out, dt, checksum

    ref, plain_ms, plain_sum = timeit(
        lambda: ranking.tiled_rank_counts_bidir(
            table, head, tail, rel, h_true, t_true, head_pos, tail_pos, hf,
            tf, N, rel_model="transe", tile=args.xla_tile),
        f"plain bidir (tile={args.xla_tile})")
    out, k1_ms, k1_sum = timeit(
        lambda: transe_rank.transe_tiled_rank_counts_bidir(
            table, head, tail, rel, h_true, t_true, head_pos, tail_pos, hf,
            tf, N),
        "K1 bidir" + (" (its plain version, cpu)" if device.type == "cpu" else ""))
    diff = {k: (out[k] - ref[k]).abs() for k in ref}
    mism = sum(int((v > 1).sum()) for v in diff.values())
    print(f"    counts vs plain (>1 off, beyond ulp-tie flips): {mism}   "
          f"speedup {plain_ms / k1_ms:.2f}x")

    # K1 and the stream add each distance in another fp32 order, so a
    # candidate within rounding of its query's pivot can count on one side
    # of it in one and on the other side in the other; over millions of
    # candidates an entry can move by more than 1 that way. A distance over
    # d terms |c + r - t| is off by at most E = (d + 2) 2^-24 S, S bounding
    # the sum of |c|, |r| and |t| over its dims; a candidate counted
    # differently lies within 4E of the pivot in the stream's own scores.
    # The band of an entry counts those candidates (two more plain passes,
    # the pivot moved down and up by 4E); a difference beyond it is a fault.
    scale = 4 * (d + 2) * 2.0**-24
    c_max = table.abs().sum(1).max()
    r_sum = rel.abs().sum(1, keepdim=True)
    eps_h = scale * (c_max + r_sum + tail.abs().sum(1, keepdim=True))
    eps_t = scale * (c_max + r_sum + head.abs().sum(1, keepdim=True))
    ends = {sign: ranking.tiled_rank_counts_bidir(
        table, head, tail, rel, h_true + sign * eps_h, t_true + sign * eps_t,
        head_pos, tail_pos, hf, tf, N, rel_model="transe", tile=args.xla_tile)
        for sign in (-1, 1)}
    beyond = 0
    for k in ref:
        f = "f" if k[2] == "f" else ""
        band = ends[-1][f"{k[:2]}{f}geq"] - ends[1][f"{k[:2]}{f}gt"]
        beyond += int((diff[k] > band).sum())
    max_diff = max(int(v.max()) for v in diff.values())
    print(f"    beyond the fp32 rounding band of the pivot: {beyond}   "
          f"largest difference {max_diff}")

    res = {"n": N, "b": B, "d": d, "f": F, "xla_tile": args.xla_tile,
           "plain_ms": round(plain_ms, 3), "k1_ms": round(k1_ms, 3),
           "speedup": round(plain_ms / k1_ms, 2), "mismatches": mism,
           "beyond_rounding_band": beyond, "max_count_diff": max_diff,
           "plain_checksum": plain_sum, "k1_checksum": k1_sum,
           **card_stats(device)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
