"""Phase 1 of evaluation: the port's `evaluation.build_entity_table` with
`blp.encode`, as `evaluation.eval_link_prediction` calls it.

Each call encodes `chunks_per_call` chunks of `emb_batch_size` entities
(`chunk_multiple` as the evaluator sets it, the prefetch thread on) from a
description store made from the seed, the blocks following one another
from a start drawn from the seed; the table is padded to `pad_to` rows, as
the evaluator pads it to its rank tile. The encoder's view (`encode_view`,
the weights cast once) is made in set-up, as one evaluation makes it once.

The check: a sample of the rows the window wrote, drawn from the seed, is
encoded again by the plain reference in float32 and normalized; the number
compared is the widest L2 gap of a row (rows have unit norm).
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
from blp_tpu_torch.models import blp

#: Rows kept from each call for the check, and the blocks the reference
#: encodes them in.
KEPT_A_CALL = 64
REF_BLOCK = 256


@dataclasses.dataclass
class State:
    store: object = None
    view: object = None
    mcfg: object = None
    encode_batch: object = None
    weights: dict | None = None
    next_start: int = 0
    calls: int = 0
    rng: object = None
    kept_ids: list = dataclasses.field(default_factory=list)
    kept_rows: list = dataclasses.field(default_factory=list)
    bad_rows: object = None


def _call_size(tr: dict) -> int:
    return tr["emb_batch_size"] * tr["chunks_per_call"]


def setup(run: Run) -> State:
    cfg, tr, dev = run.config, run.traffic, run.device
    n = tr["graph"]["entities"]
    st = State(rng=inputs.numpy_rng(run.seed, "check"))
    st.store = inputs.descriptions(n, tr["max_len"], cfg["tokens"],
                                   tr["descriptions"], run.seed, dev)
    st.weights = inputs.make_weights(run.family.leaves(cfg), run.seed, dev)
    st.mcfg = run.port.model_config(cfg)
    st.view = blp.encode_view(run.port.params(st.weights), st.mcfg)
    st.next_start = int(st.rng.integers(0, n))
    st.bad_rows = torch.zeros((), dtype=torch.int64, device=dev)

    def encode_batch(tok, mask):
        with span("encode.chunk"):
            out = blp.encode(st.view, st.mcfg, tok, mask, device=dev)
        if run.fault == "half_batch":
            out = torch.cat([out[:len(out) // 2], torch.zeros_like(out[len(out) // 2:])])
        elif run.fault == "altered":
            out = out.clone()
            out[::16] = -out[::16]
        elif run.fault is not None:
            raise ValueError(f"the encode has no fault {run.fault!r}")
        return out

    st.encode_batch = encode_batch
    _call(run, st, keep=False)
    sync(dev)
    return st


def _call(run: Run, st: State, keep: bool = True) -> int:
    tr = run.traffic
    n = tr["graph"]["entities"]
    size = _call_size(tr)
    ids = (st.next_start + np.arange(size)) % n
    st.next_start = int((st.next_start + size) % n)
    with span("encode.call"):
        table = evaluation.build_entity_table(
            st.encode_batch, st.store, ids, emb_batch_size=tr["emb_batch_size"],
            dim=run.config["blp"]["dim"], device=run.device, pad_to=tr["pad_to"],
            chunk_multiple=tr["chunk_multiple"])
    if keep:
        pick = np.sort(st.rng.choice(size, min(size, KEPT_A_CALL), replace=False))
        idx = torch.as_tensor(pick, device=run.device)
        st.kept_ids.append(ids[pick])
        st.kept_rows.append(table[idx])
        st.bad_rows += (~torch.isfinite(table[:size])).any(1).sum()
        st.calls += 1
    return size


def window(run: Run, st: State, seconds: float) -> Window:
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds:
        units += _call(run, st)
    with span("encode.sync"):
        sync(run.device)
    elapsed = time.perf_counter() - t0
    lengths = _window_lengths(run, st, units)
    return Window(units=units, seconds=elapsed, steps=st.calls,
                  attempted=units, failed=int(st.bad_rows),
                  flops=run.family.forward_flops(run.config, lengths))


def _window_lengths(run: Run, st: State, units: int) -> np.ndarray:
    n = run.traffic["graph"]["entities"]
    first = (st.next_start - units) % n
    return st.store.lengths[(first + np.arange(units)) % n]


def release(st: State) -> None:
    st.view = st.encode_batch = None
    st.kept_rows = torch.cat(st.kept_rows).cpu()
    st.kept_ids = np.concatenate(st.kept_ids)


def reference_rows(run: Run, st: State, ids: np.ndarray,
                   mode: str = "fp32") -> torch.Tensor:
    """The plain reference's normalized rows of entities `ids`."""
    out = []
    with torch.no_grad(), common.precision(mode):
        for b0 in range(0, len(ids), REF_BLOCK):
            tok, mask = st.store.get_entity_descriptions(ids[b0:b0 + REF_BLOCK])
            rows = run.family.encode(run.config, st.weights,
                                     torch.as_tensor(tok, device=run.device),
                                     torch.as_tensor(mask, device=run.device),
                                     mode=mode)
            out.append(common.l2_normalize(rows).cpu())
    return torch.cat(out)


def sample(run: Run, st: State) -> np.ndarray:
    """The kept rows the check compares: `check_rows` of them, from the seed."""
    n = min(run.traffic["check_rows"], len(st.kept_ids))
    return np.sort(inputs.numpy_rng(run.seed, "check").choice(
        len(st.kept_ids), n, replace=False))


def compare(program: torch.Tensor, reference: torch.Tensor) -> dict:
    return {"row_gap": float((program - reference).norm(dim=1).max())}


def check(run: Run, st: State) -> dict:
    pick = sample(run, st)
    return compare(st.kept_rows[pick],
                   reference_rows(run, st, st.kept_ids[pick]))
