"""The port's span recorder (blp_tpu_torch/profiling.py `span`, `recording`,
`trace`) and the spans at its layer boundaries: the train step's four
stages, the prefetch thread's two, and the rank loop's host work, each
recorded without changing what the code computes."""

import contextlib
import glob
import json
import threading

import numpy as np
import torch

from blp_tpu_torch import evaluation, profiling, training
from blp_tpu_torch.checkpoint import tree_leaves
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.models import bert, blp

B, K, L = 8, 4, 8
STEP = ["train.sample", "train.forward", "train.backward", "train.optimizer"]


def test_span_off_is_one_shared_null_context():
    before = len(profiling.kept_spans())
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert len(profiling.kept_spans()) == before


def test_recording_nests_spans_and_keeps_other_threads():
    def worker():
        with profiling.span("thread.outer"):
            with profiling.span("thread.inner"):
                pass

    with profiling.recording() as spans:
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
        with profiling.span("next"):
            pass
    assert not t.is_alive()
    assert [s.name for s in spans] == ["outer", "inner", "thread.outer",
                                       "thread.inner", "next"]
    by = {s.name: s for s in spans}
    assert by["outer"].thread == by["next"].thread == threading.get_native_id()
    assert by["outer"].ident == threading.get_ident() != by["thread.outer"].ident
    assert by["thread.outer"].thread == by["thread.inner"].thread != by["outer"].thread
    assert by["outer"].parent == by["next"].parent == by["thread.outer"].parent == -1
    assert by["inner"].parent == by["outer"].seq
    assert by["thread.inner"].parent == by["thread.outer"].seq
    assert by["outer"].start <= by["inner"].start <= by["inner"].end <= by["outer"].end
    assert by["outer"].end <= by["next"].start
    assert profiling.span("after") is profiling.span("again")   # off once left


def test_span_clock_agrees_with_the_profiler():
    """A span opened under the profiler is recorded, and stamped on the
    clock of the profiler's own host events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):      # the first pass pays record_function's set-up
            with torch.profiler.record_function("rf"):
                with profiling.span("rec") as s:
                    torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(k is s for k in profiling.kept_spans())
    rf = max((e for e in prof.profiler.kineto_results.events() if e.name() == "rf"),
             key=lambda e: e.start_ns())
    assert abs(rf.start_ns() - s.start) < 1_000_000
    assert abs(rf.start_ns() + rf.duration_ns() - s.end) < 1_000_000


def test_trace_writes_the_spans_on_their_threads(tmp_path):
    def worker():
        with profiling.span("side"):
            pass

    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "side")}
    assert spans["outer"]["tid"] == threading.get_native_id() != spans["side"]["tid"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    outer = spans["outer"]
    assert outer["ts"] - 1e3 <= mm["ts"] <= mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"] + 1e3
    ops = {op["name"] for op in profiling.summarize_trace_stats(str(tmp_path))["top_ops"]}
    assert "aten::mm" in ops and not ops & {"outer", "side"}


def _tiny_step():
    cfg = blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin", dim=16,
                          num_relations=3, num_entities=40, emb_dim=24, vocab_size=128,
                          encoder=bert.BertConfig.tiny())
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    opt = training.make_optimizer(1e-3, 10)
    rng = np.random.default_rng(7)
    lens = rng.integers(2, L + 1, (B, 2))
    batch = {"rels": torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)),
             "text_tok": torch.from_numpy(rng.integers(1, 128, (B, 2, L)).astype(np.int32)),
             "text_mask": torch.from_numpy((np.arange(L) < lens[..., None]).astype(np.float32))}
    step = training.make_train_step(cfg, opt, batch_size=B, num_negatives=K, device="cpu")
    return step, params, opt.init(params), batch


def test_train_step_records_its_four_stages_and_keeps_its_bits():
    step, params, state, batch = _tiny_step()
    want = step(params, state, (4, 2), batch)
    with profiling.recording() as spans:
        got = step(params, state, (4, 2), batch)
    assert [s.name for s in spans] == STEP
    assert all(a.end <= b.start for a, b in zip(spans, spans[1:]))
    for x, y in zip(tree_leaves(want), tree_leaves(got), strict=True):
        assert torch.equal(x, y)


def _rank_inputs(n=300, dim=16, triples=50, rels=4):
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(1)
    test = np.stack([rng.integers(0, n, triples), rng.integers(0, n, triples),
                     rng.integers(0, rels, triples)], 1).astype(np.int64)
    known = np.concatenate([test, np.stack([
        rng.integers(0, n, 400), rng.integers(0, n, 400),
        rng.integers(0, rels, 400)], 1).astype(np.int64)])
    table = torch.nn.functional.normalize(torch.randn(n, dim, generator=g), dim=1)
    params = {"rel_emb": torch.randn(rels, dim, generator=g)}
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=dim, num_relations=rels,
                          encoder=bert.BertConfig.tiny())
    return params, cfg, test, np.arange(n), FilterIndex(known), table


def test_eval_records_its_host_work_per_batch_and_keeps_its_result():
    params, cfg, test, entities, index, table = _rank_inputs()
    kw = dict(batch_size=16, tile=256, filter_index=index, ent_emb=table, device="cpu")
    want = evaluation.eval_link_prediction(params, cfg, test, None, entities, **kw)
    with profiling.recording() as spans:
        got = evaluation.eval_link_prediction(params, cfg, test, None, entities, **kw)
    batches = -(-len(test) // 16)
    assert [s.name for s in spans] == (
        ["eval.ent2idx", "eval.filters"]
        + ["eval.batch_filters", "eval.to_device", "eval.rank_batch"] * batches
        + ["eval.read_counts", "eval.finish"])
    assert got.scalars("test") == want.scalars("test")
    assert got.mrr_filt == want.mrr_filt and got.hits_filt == want.hits_filt


def test_prefetch_records_its_spans_on_its_own_thread():
    batches = [{"x": np.full(4, i, np.float32)} for i in range(3)]
    with profiling.recording() as spans:
        out = list(prefetch.prefetch_to_device(iter(batches), device="cpu"))
    assert [float(b["x"][0]) for b in out] == [0.0, 1.0, 2.0]
    assert [s.name for s in spans] == (["prefetch.assemble", "prefetch.place"] * 3
                                       + ["prefetch.assemble"])
    (thread,) = {s.thread for s in spans}
    assert thread != threading.get_native_id()
