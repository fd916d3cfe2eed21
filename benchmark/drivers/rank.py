"""Phase 2 of evaluation: the port's `evaluation.eval_link_prediction` with
the candidate table given, filtered, over the test triples.

Set-up makes the table on the device from the seed, at the padded size the
evaluator streams (so no call copies it to pad it), the test triples and a
known-true set with heavy-tailed answers per query, indexed once in the
port's `FilterIndex`; the relation table comes from the configuration's
weights. Each call of the window ranks every test triple in both
directions, raw and filtered.

The check: the rank counts of K1's path (`transe_rank.
transe_tiled_rank_counts_bidir`, which the evaluator calls once a batch)
are kept for one batch of each call, chosen from the seed; after the
window a sample of those batches is counted again by the plain reference
in the same documented fp32 add order, and every count must be equal.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Run, Window, sync
from benchmark.models import common
from benchmark.trace import span
from blp_tpu_torch import evaluation
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.ops import transe_rank

KEYS = ("h_gt", "h_geq", "h_fgt", "h_fgeq", "t_gt", "t_geq", "t_fgt", "t_fgeq")


@dataclasses.dataclass
class State:
    table: object = None
    params: dict | None = None
    mcfg: object = None
    test: np.ndarray | None = None
    known: np.ndarray | None = None
    index: object = None
    entities: np.ndarray | None = None
    rng: object = None
    original: object = None
    calls: int = 0
    batch_in_call: int = 0
    want: int = -1
    kept: list = dataclasses.field(default_factory=list)


def n_pad(tr: dict) -> int:
    n, tile = tr["graph"]["entities"], tr["tile"]
    tile = min(tile, -(-n // 256) * 256)
    return -(-n // tile) * tile


def batches_a_call(tr: dict) -> int:
    return -(-tr["graph"]["test_triples"] // tr["eval_batch_size"])


def setup(run: Run) -> State:
    cfg, tr, dev = run.config, run.traffic, run.device
    g = tr["graph"]
    n, dim = g["entities"], cfg["blp"]["dim"]
    st = State(rng=inputs.numpy_rng(run.seed, "check"))
    st.table = inputs.rank_table(n, n_pad(tr), dim, run.seed, dev)
    rel = [leaf for leaf in run.family.leaves(cfg) if leaf[0] == "rel_emb"]
    st.params = inputs.make_weights(rel, run.seed, dev)
    st.mcfg = run.port.model_config(cfg)
    st.test = inputs.triples(g["test_triples"], n, cfg["blp"]["num_relations"],
                             run.seed, dev).astype(np.int64)
    f = tr["filters"]
    st.known = inputs.known_true(st.test, n, f["pareto_alpha"], f["cap"], run.seed)
    st.index = FilterIndex(st.known)
    st.entities = np.arange(n, dtype=np.int64)
    st.original = transe_rank.transe_tiled_rank_counts_bidir
    transe_rank.transe_tiled_rank_counts_bidir = _capturing(run, st)
    _call(run, st)
    st.kept.clear()
    sync(dev)
    return st


def _capturing(run: Run, st: State):
    """K1's bidirectional counts, passed through; the batch the call was
    told to keep is kept (device tensors, no sync)."""
    def counts(*args, **kwargs):
        out = st.original(*args, **kwargs)
        if run.fault == "half_batch":
            out = {k: torch.cat([v[:len(v) // 2], torch.zeros_like(v[len(v) // 2:])])
                   for k, v in out.items()}
        elif run.fault == "altered":
            out = {k: torch.roll(v, 1) for k, v in out.items()}
        elif run.fault is not None:
            raise ValueError(f"the rank pass has no fault {run.fault!r}")
        if st.batch_in_call == st.want:
            st.kept.append((st.calls, st.want, out))
        st.batch_in_call += 1
        return out
    return counts


def _call(run: Run, st: State) -> None:
    tr = run.traffic
    st.batch_in_call = 0
    st.want = int(st.rng.integers(0, batches_a_call(tr)))
    with span("rank.call"):
        evaluation.eval_link_prediction(
            st.params, st.mcfg, st.test, None, st.entities,
            batch_size=tr["eval_batch_size"], tile=tr["tile"],
            filter_index=st.index, ent_emb=st.table, device=run.device)
    st.calls += 1


def window(run: Run, st: State, seconds: float) -> Window:
    first = st.calls
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _call(run, st)
    with span("rank.sync"):
        sync(run.device)
    elapsed = time.perf_counter() - t0
    calls = st.calls - first
    tr = run.traffic
    t = tr["graph"]["test_triples"]
    ops = 2.0 * (2 * t) * tr["graph"]["entities"] * run.config["blp"]["dim"]
    return Window(units=calls * t, seconds=elapsed, steps=calls,
                  attempted=calls * t, rank_ops=calls * ops)


def release(st: State) -> None:
    transe_rank.transe_tiled_rank_counts_bidir = st.original
    st.kept = [(c, b, {k: v.cpu() for k, v in out.items()}) for c, b, out in st.kept]


def batch_inputs(run: Run, st: State, b: int, device) -> dict:
    """Batch b's triples, positions and filters, as the reference takes them."""
    bs = run.traffic["eval_batch_size"]
    rows = st.test[b * bs:(b + 1) * bs]
    n = run.traffic["graph"]["entities"]
    hf, tf = common.filters_of(rows, st.known, n,
                               width=max(1, run.traffic["filters"]["cap"] + 1))
    dev = device
    return {"real": len(rows),
            "head": torch.as_tensor(rows[:, 0], device=dev),
            "tail": torch.as_tensor(rows[:, 1], device=dev),
            "rel": st.params["rel_emb"][torch.as_tensor(rows[:, 2], device=dev)],
            "hf": torch.as_tensor(hf, device=dev), "tf": torch.as_tensor(tf, device=dev)}


def reference_counts(run: Run, st: State, b: int, mode: str = "fp32") -> dict:
    x = batch_inputs(run, st, b, run.device)
    out = common.rank_counts(st.table, x["head"], x["tail"], x["rel"], x["hf"],
                             x["tf"], run.traffic["graph"]["entities"], mode=mode)
    return {k: v.cpu() for k, v in out.items()}


def sample(run: Run, st: State) -> list:
    rng = inputs.numpy_rng(run.seed, "check")
    n = min(run.traffic["check_batches"], len(st.kept))
    return [st.kept[i] for i in sorted(rng.choice(len(st.kept), n, replace=False))]


def compare(program: list[dict], reference: list[dict], real: list[int]) -> dict:
    """count_mismatches: the counts of the real rows that differ."""
    bad = 0
    for p, r, m in zip(program, reference, real):
        for k in KEYS:
            bad += int((p[k][:m].long() != r[k][:m].long()).sum())
    return {"count_mismatches": float(bad)}


def check(run: Run, st: State) -> dict:
    picked = sample(run, st)
    bs = run.traffic["eval_batch_size"]
    t = run.traffic["graph"]["test_triples"]
    real = [min(bs, t - b * bs) for _, b, _ in picked]
    ref = [reference_counts(run, st, b) for _, b, _ in picked]
    return compare([out for _, _, out in picked], ref, real)
