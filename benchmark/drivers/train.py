"""Training traffic: the port's train step on batches its loader assembles.

As the port's `train.link_prediction` runs it: `training.make_train_step`
with Adam at the configuration's keys, fed by `data.loader.epoch_batches`
and `text_train_batch` over a graph made from the seed, through
`data.prefetch.prefetch_to_device`; step keys (seed, global step).

Set-up builds that one step, its parameters and its Adam state, and drives
them through the first `check_steps` steps, which warm every shape up; the
window goes on with the same objects and the same loader. The check: the
plain reference follows those first steps from the same weights and
batches, with the masks and negatives worked out again, and the program's
loss at each step, its first gradient (from Adam's first moment after one
step) and its parameters' change over the steps are compared leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Run, Window, flatten, sync
from benchmark.models import common
from benchmark.trace import span
from blp_tpu_torch import training
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.loader import epoch_batches, text_train_batch

#: Leaves whose reference gradient is below this share of the median leaf's
#: move by round-off alone; their change is not compared.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class State:
    step: object = None
    params: object = None
    opt_state: object = None
    batches: object = None
    key: int = 0
    steps_done: int = 0
    weights: dict | None = None
    check_batches: list = dataclasses.field(default_factory=list)
    lengths: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    grad1: dict | None = None
    change_norms: dict | None = None


def total_steps(run: Run) -> int:
    tr = run.traffic
    return (tr["graph"]["train_triples"] // tr["batch_size"]) * \
        run.config["training"]["max_epochs"]


def setup(run: Run) -> State:
    cfg, tr, dev = run.config, run.traffic, run.device
    B, L, K = tr["batch_size"], tr["max_len"], tr["num_negatives"]
    g = tr["graph"]
    store = inputs.descriptions(g["entities"], L, cfg["tokens"],
                                tr["descriptions"], run.seed, dev)
    graph = inputs.TextGraph(store, inputs.triples(
        g["train_triples"], g["entities"], cfg["blp"]["num_relations"],
        run.seed, dev))
    st = State(weights=inputs.make_weights(run.family.leaves(cfg), run.seed, dev))
    mcfg = run.port.model_config(cfg)
    st.params = training.unstack_params(run.port.params(st.weights))
    t = cfg["training"]
    optimizer = training.make_optimizer(t["lr"], total_steps(run),
                                        t["use_scheduler"])
    st.opt_state = optimizer.init(st.params)
    half = run.fault == "half_batch"
    step = training.make_train_step(mcfg, optimizer,
                                    batch_size=B // 2 if half else B,
                                    num_negatives=K, device=dev)
    if run.fault == "unchanged":
        def broken(params, opt_state, key, batch):
            loss = step(params, opt_state, key, batch)[2]
            return params, opt_state, loss
        st.step = broken
    elif half:
        st.step = lambda p, o, k, b: step(p, o, k, {n: v[:B // 2] for n, v in b.items()})
    elif run.fault is None:
        st.step = step
    else:
        raise ValueError(f"training has no fault {run.fault!r}")
    st.key = common.fold_seed(run.seed, inputs.STREAM["train_key"])

    n_check = tr["check_steps"]

    def host_batches():
        order = inputs.numpy_rng(run.seed, "order")
        while True:
            for triples in epoch_batches(graph, B, rng=order):
                with span("loader.batch"):
                    batch = text_train_batch(graph, triples)
                st.lengths.append(graph.lengths[triples[:, :2].reshape(-1)])
                if len(st.check_batches) < n_check:
                    st.check_batches.append({k: np.array(v) for k, v in batch.items()})
                yield batch

    st.batches = prefetch.prefetch_to_device(
        host_batches(), placement=lambda b: prefetch.to_device(b, dev))
    for s in range(n_check):
        _step(st)
        if s == 0:
            (_, mu, _), _ = st.opt_state
            st.grad1 = {k: (v.float() / (1 - common.B1)).cpu()
                        for k, v in flatten(mu).items()}
    start = flatten(training.unstack_params(run.port.params(st.weights)))
    st.change_norms = {k: (v.float() - start[k].float()).norm()
                       for k, v in flatten(st.params).items()}
    # The program holds its own tensors from the first update on: the
    # reference's copy of the weights waits on the host.
    st.weights = {k: v.cpu() for k, v in st.weights.items()}
    sync(dev)
    return st


def _step(st: State):
    with span("loader.wait"):
        batch = next(st.batches)
    with span("train.step"):
        st.params, st.opt_state, loss = st.step(st.params, st.opt_state,
                                                (st.key, st.steps_done), batch)
    st.losses.append(loss)
    st.steps_done += 1


def window(run: Run, st: State, seconds: float) -> Window:
    first = st.steps_done
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _step(st)
    with span("train.sync"):
        sync(run.device)
    elapsed = time.perf_counter() - t0
    steps = st.steps_done - first
    with span("train.loss_read"):
        losses = torch.tensor([float(x) for x in st.losses[first:]])
    B = run.traffic["batch_size"]
    lengths = np.concatenate([np.zeros(0, np.int32)] + st.lengths[first:st.steps_done])
    bad = int((~torch.isfinite(losses)).sum())
    return Window(units=steps * B, seconds=elapsed, steps=steps,
                  attempted=steps * B, failed=bad * B,
                  flops=run.family.train_flops(run.config, lengths))


def release(st: State) -> None:
    st.step = st.params = st.opt_state = st.batches = None
    st.losses = [float(x) for x in st.losses[:len(st.check_batches)]]
    st.change_norms = {k: float(v) for k, v in st.change_norms.items()}


def program_readings(st: State) -> dict:
    return {"losses": st.losses, "grad1": st.grad1, "change": st.change_norms}


def reference_readings(run: Run, st: State, mode: str = "fp32") -> dict:
    """The plain reference's losses, first-gradient norms and change norms
    over the same first steps, in `mode` (the configuration's precision is
    "fp32"; a lower one is the control)."""
    cfg, tr, dev = run.config, run.traffic, run.device
    fam = run.family
    B, K = tr["batch_size"], tr["num_negatives"]
    t = cfg["training"]
    lr_at = common.schedule(t["lr"], total_steps(run), t["use_scheduler"],
                            t.get("warmup_frac", 0.2))
    start = {k: v.to(dev) for k, v in st.weights.items()}
    params = {k: v.clone() for k, v in start.items()}
    adam = common.Adam(params, lr_at)
    losses, grad1 = [], None
    for s, batch in enumerate(st.check_batches):
        neg_seed, drop_seed = common.step_seeds(st.key, s)
        tok = torch.as_tensor(batch["text_tok"], device=dev)
        n, two, L = tok.shape
        mask = torch.as_tensor(batch["text_mask"], device=dev).reshape(n * two, L)
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with common.precision(mode):
            rows = fam.train_encode(cfg, live, tok.reshape(n * two, L), mask,
                                    drop_seed, mode=mode)
            ent = common.l2_normalize(rows).reshape(n, two, -1)
            rel = live["rel_emb"][torch.as_tensor(batch["rels"], device=dev).long()]
            loss = common.transe_margin_loss(
                ent, rel, common.negatives(neg_seed, B, K, dev),
                cfg["blp"]["regularizer"])
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(live.items(), grads)}
        losses.append(float(loss.detach()))
        if s == 0:
            grad1 = {k: v.cpu() for k, v in fam.layer_leaves(grads).items()}
        del live, rows, ent, loss
        params = adam.update(params, grads)
        del grads
    change = {}
    for k, v in fam.layer_leaves({k: params[k] - start[k] for k in params}).items():
        change[k] = float(v.norm())
    return {"losses": losses, "grad1": grad1, "change": change}


def compare(program: dict, reference: dict) -> dict:
    """loss_gap: the widest relative gap of a step's loss; grad_gap and
    change_gap: `common.worst_leaf_gap` of the first gradient's and of the
    change's leaf norms, the change without the leaves whose reference
    gradient is below STILL_LEAF of the median leaf's; grad_diff_gap: the
    median leaf's norm of the first gradients' difference over the larger
    of its reference norm and the median leaf's (a gap of norms hardly
    sees rounding noise that is as often up as down; this reads it)."""
    ref_norm = {k: float(v.norm()) for k, v in reference["grad1"].items()}
    prog_norm = {k: float(program["grad1"][k].norm()) for k in ref_norm}
    diff = {k: float((program["grad1"][k] - reference["grad1"][k]).norm())
            for k in ref_norm}
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"], reference["losses"]))
    median = float(np.median(list(ref_norm.values())))
    moving = {k for k, v in ref_norm.items() if v >= STILL_LEAF * median}
    return {"loss_gap": loss_gap,
            "grad_gap": common.worst_leaf_gap(prog_norm, ref_norm)[0],
            "change_gap": common.worst_leaf_gap(program["change"], reference["change"],
                                                keep=moving)[0],
            "grad_diff_gap": float(np.median(list(common.per_leaf(diff, ref_norm).values())))}


def worst_leaves(program: dict, reference: dict) -> dict:
    """The leaf behind grad_gap and behind change_gap (for calibration)."""
    ref_norm = {k: float(v.norm()) for k, v in reference["grad1"].items()}
    prog_norm = {k: float(program["grad1"][k].norm()) for k in ref_norm}
    median = float(np.median(list(ref_norm.values())))
    moving = {k for k, v in ref_norm.items() if v >= STILL_LEAF * median}
    return {"grad": common.worst_leaf_gap(prog_norm, ref_norm)[1],
            "change": common.worst_leaf_gap(program["change"], reference["change"],
                                            keep=moving)[1]}


def check(run: Run, st: State) -> dict:
    return compare(program_readings(st), reference_readings(run, st))
