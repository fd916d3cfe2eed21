#!/usr/bin/env python3
"""The word tables' gather backward on one NVIDIA GPU: torch's index backward
against `index_put_segsum` (blp_tpu_torch/ops/row_gather.py) and
F.embedding's backward, in turns, at the W5M train step's positions.

    python3 word_grad_probe.py [--out build/word_grad_probe.json]

Every case has 131,072 positions (2,048 descriptions of 64 tokens):

  glove, bert     the ids of the benchmark's w5m-train traffic
                  (benchmark/inputs.py `descriptions`, seed 0) over the
                  glove-dkrl table (400,001 x 300) and blp-bert-base's
                  (28,996 x 768): ~9% of the positions are padding, id 0;
  *-spread        the same ids with each padded position moved to a row of
                  its own (distinct rows no real token uses);
  synth           bert's table with descriptions of 6..14 tokens ([CLS], 4..12
                  words, [SEP]), as in chip_smoke.py's synth4096 step: ~84%
                  of the positions on id 0;
  one-id          all 131,072 positions on row 0 of the GloVe table.

For each case it records the longest run of one id and the share of the
positions in runs that cross a chunk boundary (the kernel's second phase),
then times the backward of the gather (`torch.autograd.grad` of the rows
against a fixed cotangent) through plain indexing (torch: a fill, a sort,
`indexing_backward_kernel`), through `gather_rows` (a fill, the zeroed
counters, a sort, `index_put_segsum`) and through
aten.embedding_dense_backward (F.embedding's backward: a sort, then sums of
partial segments of at most 10 positions and of each id's partials) in
turns, torch, kernel, embedding, embedding, kernel, torch, with CUDA events
over a few calls each, and `segment_sum_plain` (the kernel's arithmetic in
PyTorch) once; then one call of each under torch.profiler, its device time
by part (fill, sort, the kernel). It records each gradient's largest gap to
a float64 sum of the same contributions and whether two calls of the kernel,
and of the embedding backward, give the same bits, and writes everything to
--out as JSON.

The bound of the kernel is bytes over 3.35 TB/s: g read once and the touched
rows written once; "dense" adds the zero fill of the whole table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import inputs
from blp_tpu_torch.ops import _cuda, row_gather

HBM_BYTES_PER_S = 3.35e12
DESCRIPTIONS, L = 2048, 64
ROOT = os.path.dirname(os.path.abspath(__file__))


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def _traffic() -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", "w5m-train.json")) as f:
        return json.load(f)


def cell_ids(config: str) -> tuple[torch.Tensor, int, int]:
    """(ids (2,048, 64) on the card, table rows, width) of a train cell."""
    cfg = _config(config)
    store = inputs.descriptions(DESCRIPTIONS, L, cfg["tokens"], _traffic()["descriptions"],
                                seed=0, device="cuda")
    rows = cfg.get("vocab_rows", cfg.get("vocab_size"))
    width = cfg.get("word_dim", cfg.get("hidden_size"))
    return torch.from_numpy(store.tok.astype(np.int64)).to("cuda"), rows, width


def spread(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """ids with each 0 moved to a row that no real token uses, a row each
    while such rows last (BERT's table runs short: then two each)."""
    out = ids.clone()
    pad = out == 0
    free = torch.ones(rows, dtype=torch.bool, device=ids.device)
    free[ids.reshape(-1)] = False
    spare = torch.nonzero(free).squeeze(1)
    count = int(pad.sum())
    out[pad] = spare[torch.arange(count, device=ids.device) % spare.numel()]
    return out


def synth_ids(rows: int) -> torch.Tensor:
    """BERT-style rows of 6..14 tokens padded to 64, Zipf words (rank ids)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = torch.randint(6, 15, (DESCRIPTIONS,), generator=gen, device="cuda")
    cdf = inputs.zipf_cdf(rows - 104, 1.0, "cuda")
    words = 104 + torch.searchsorted(cdf, torch.rand((DESCRIPTIONS, L), generator=gen,
                                                     device="cuda", dtype=torch.float64))
    col = torch.arange(L, device="cuda")
    ids = torch.where(col == 0, 101, words.clamp_(max=rows - 1))
    ids = torch.where(col[None] == lengths[:, None] - 1, 102, ids)
    return torch.where(col[None] < lengths[:, None], ids, 0)


def engagement(ids: torch.Tensor) -> dict:
    """The longest run of one id, and the share of the positions in runs that
    cross a multiple of CHUNK in sorted order."""
    flat = torch.sort(ids.reshape(-1)).values
    _, counts = torch.unique_consecutive(flat, return_counts=True)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    crossing = (starts // row_gather.CHUNK) != ((ends - 1) // row_gather.CHUNK)
    return {"positions": flat.numel(), "distinct_rows": counts.numel(),
            "longest_run": int(counts.max()),
            "crossing_share_pct": 100.0 * float(counts[crossing].sum()) / flat.numel(),
            "crossing_runs": int(crossing.sum())}


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _part(name: str) -> str:
    low = name.lower()
    if "index_put_segsum" in low or "indexing_backward" in low:
        return "kernel"
    if any(k in low for k in ("radixsort", "radix_sort", "segmented_sort", "sort_kernel",
                              "sortpairs", "devicescan")):
        return "sort"
    if "fill" in low or "memset" in low:
        return "fill"
    return "other"


def _device_parts(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    names = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            p = _part(e.key)
            parts[p] = parts.get(p, 0.0) + e.self_device_time_total / 1e3
            names.setdefault(p, []).append(e.key[:80])
    return {"ms": {k: round(v, 4) for k, v in parts.items()}, "kernels": names}


def measure(name: str, ids: torch.Tensor, rows: int, width: int) -> dict:
    res = {"case": name, "rows": rows, "width": width, **engagement(ids)}
    n = ids.numel()
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(tuple(ids.shape) + (width,), generator=gen, device="cuda")
    table = torch.zeros((rows, width), device="cuda", requires_grad=True)
    plain_rows = table[ids]
    kernel_rows = row_gather.gather_rows(table, ids)

    def torch_grad():
        return torch.autograd.grad(plain_rows, table, g, retain_graph=True)[0]

    def kernel_grad():
        return torch.autograd.grad(kernel_rows, table, g, retain_graph=True)[0]

    def embedding_grad():
        return torch.ops.aten.embedding_dense_backward(g, ids, rows, -1, False)

    want, got, emb = torch_grad(), kernel_grad(), embedding_grad()
    exact = torch.zeros((rows, width), dtype=torch.float64, device="cuda")
    exact.index_add_(0, ids.reshape(-1), g.reshape(-1, width).double())
    res["max_abs_err_kernel"] = float((got.double() - exact).abs().max())
    res["max_abs_err_torch"] = float((want.double() - exact).abs().max())
    res["max_abs_err_embedding"] = float((emb.double() - exact).abs().max())
    res["bits_equal_kernel_calls"] = bool(torch.equal(got, kernel_grad()))
    res["bits_equal_embedding_calls"] = bool(torch.equal(emb, embedding_grad()))
    del want, got, emb, exact
    touched = res["distinct_rows"]
    res["bound_ms"] = 1e3 * 4 * (n * width + touched * width) / HBM_BYTES_PER_S
    res["bound_dense_ms"] = 1e3 * 4 * (n * width + rows * width) / HBM_BYTES_PER_S
    reps_torch = 3 if res["longest_run"] > 50_000 else 10
    sides = {"torch": (torch_grad, reps_torch), "kernel": (kernel_grad, 20),
             "embedding": (embedding_grad, 20)}
    times = {side: [] for side in sides}
    for side in ("torch", "kernel", "embedding", "embedding", "kernel", "torch"):
        fn, reps = sides[side]
        times[side].append(_events_ms(fn, reps))
    res["events_ms"] = times
    res["plain_ms"] = _events_ms(lambda: row_gather.segment_sum_plain(g, ids, rows), 1)
    launches = row_gather.launches
    res["device_torch"] = _device_parts(torch_grad)
    res["device_kernel"] = _device_parts(kernel_grad)
    res["device_embedding"] = _device_parts(embedding_grad)
    res["kernel_launches_profiled"] = row_gather.launches - launches
    k = res["device_kernel"]["ms"]
    res["layer_ms_kernel"] = k.get("kernel", 0.0) + k.get("sort", 0.0)
    res["layer_ms_torch"] = (res["device_torch"]["ms"].get("kernel", 0.0)
                             + res["device_torch"]["ms"].get("sort", 0.0))
    e = res["device_embedding"]["ms"]
    res["layer_ms_embedding"] = sum(v for p, v in e.items() if p != "fill")
    res["kernel_share_of_bound_pct"] = 100.0 * res["bound_ms"] / max(k.get("kernel", 1e-9), 1e-9)
    print(f"{name:13s} longest run {res['longest_run']:7d}, crossing "
          f"{res['crossing_share_pct']:5.1f}% of positions; layer (sort + kernel) "
          f"torch {res['layer_ms_torch']:.3f} ms, ours {res['layer_ms_kernel']:.3f} ms, "
          f"embedding backward {res['layer_ms_embedding']:.3f} ms "
          f"(kernel {k.get('kernel', 0):.4f} ms, {res['kernel_share_of_bound_pct']:.1f}% "
          f"of its {res['bound_ms']:.4f} ms bound); events {times}; "
          f"err torch {res['max_abs_err_torch']:.2e} ours {res['max_abs_err_kernel']:.2e} "
          f"embedding {res['max_abs_err_embedding']:.2e}",
          flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/word_grad_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("word_grad_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print("card", card, "torch", torch.__version__, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cases = []
    for config, label in (("glove-dkrl", "glove"), ("blp-bert-base", "bert")):
        ids, rows, width = cell_ids(config)
        cases += [(label, ids, rows, width), (f"{label}-spread", spread(ids, rows), rows, width)]
    bert_rows = cases[2][2]
    cases.append(("synth", synth_ids(bert_rows), bert_rows, 768))
    cases.append(("one-id", torch.zeros((DESCRIPTIONS, L), dtype=torch.long, device="cuda"),
                  cases[0][2], cases[0][3]))
    res = {"card": card, "torch": torch.__version__, "chunk": row_gather.CHUNK, "cases": []}
    for case in cases:
        res["cases"].append(measure(*case))
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
