"""The port's profiling module (blp_tpu_torch/profiling.py) against the JAX
package's: StepTimer's summary for the same step times, `trace` ->
`summarize_trace_stats` on CPU ops with the keys of JAX's
`summarize_hlo_stats` (mirroring tests/test_train_e2e.py's check), the
kernel groups, `realize`, and `device_memory_stats` on the CPU."""

import json
import glob

import numpy as np
import pytest
import torch

from blp_tpu import profiling as j_profiling
from blp_tpu_torch import profiling


@pytest.mark.parametrize("times", [[], [0.5], [3.0, 0.1, 0.2, 0.4, 0.15],
                                   list(np.linspace(0.01, 0.09, 17))])
def test_step_timer_summary_equals_jax(times):
    t, j = profiling.StepTimer(), j_profiling.StepTimer()
    t.times, j.times = list(times), list(times)
    assert t.summary() == j.summary()


def test_step_timer_times_steps_and_syncs_every_n():
    timer = profiling.StepTimer(sync_every=2)
    values = []
    for i in range(4):
        with timer.step():
            loss = torch.tensor([float(i), -1.0])
        values.append(timer.sync(loss))
    assert values == [None, 1.0, None, 3.0]
    assert len(timer.times) == 4 and all(s >= 0 for s in timer.times)
    assert timer.summary()["steps"] == 3       # the first step is dropped
    assert profiling.realize(np.array([[2.5, 1.0]])) == 2.5


def test_trace_then_summarize_on_cpu_ops(tmp_path):
    x = torch.ones((32, 32))
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("three products"):
            for _ in range(3):
                y = (x @ x).sum()
    assert float(y) == 32.0 ** 3
    out = profiling.summarize_trace_stats(str(tmp_path / "tr"), top=4)
    assert {"total_device_time_us", "by_category_us", "top_ops"} <= set(out)
    assert out["total_device_time_us"] > 0
    assert out["total_device_time_us"] == pytest.approx(
        sum(out["by_category_us"].values()))
    assert 0 < len(out["top_ops"]) <= 4
    for op in out["top_ops"]:
        assert set(op) == {"name", "category", "occurrences", "self_time_us"}
        assert op["occurrences"] >= 1 and op["self_time_us"] >= 0
        assert op["category"] == profiling.kernel_group(op["name"])
    mm = [op for op in out["top_ops"] if op["name"] == "aten::mm"]
    assert mm and mm[0]["occurrences"] == 3
    # The span is an event of its own in the written trace.
    (path,) = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "three products" in names
    assert profiling.summarize_trace_stats(str(tmp_path / "empty")) is None


def test_self_times_subtract_nested_ops(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 1,
               "ts": ts, "dur": dur}
              for n, ts, dur in (("outer", 0, 10), ("inner", 2, 3),
                                 ("inner", 6, 2), ("next", 12, 1))]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    out = profiling.summarize_trace_stats(str(tmp_path))
    got = {op["name"]: (op["occurrences"], op["self_time_us"])
           for op in out["top_ops"]}
    assert got == {"outer": (1, 5.0), "inner": (2, 5.0), "next": (1, 1.0)}
    assert out["total_device_time_us"] == 11.0


def test_device_events_count_kernels_and_copies_only(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "transe_rank_tma<128>", "ts": 1, "dur": 6},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 8, "dur": 4},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 13, "dur": 1},
    ]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    out = profiling.summarize_trace_stats(str(tmp_path))
    assert out["total_device_time_us"] == 11.0
    assert out["by_category_us"] == {
        "K1 transe_rank": 6.0, "GEMM (cuBLAS)": 4.0, "copies": 1.0}


@pytest.mark.parametrize("name,group", [
    ("void packed_attention_kernel<64>(...)", "K2 packed_attention"),
    ("transe_rank_scalar", "K1 transe_rank"),
    ("sddmm_bwd_kernel", "K3 sddmm backward"),
    ("sddmm_fwd<4>", "K3 sddmm forward"),
    ("nvjet_tst_128x64", "GEMM (cuBLAS)"),
    ("void (anonymous namespace)::bias_act_fwd<__nv_bfloat16>(...)", "F1 F2 F3 site"),
    ("add_ln_bwd<float, __nv_bfloat16>", "F1 F2 F3 site"),
    ("attn_softmax_tile_fwd<__nv_bfloat16>", "F1 F2 F3 site"),
    ("site_dropout_kernel", "F1 F2 F3 site"),
    ("void at::native::indexing_backward_kernel<float, 4>", "index backward"),
    ("cub::DeviceRadixSortOnesweepKernel", "index backward"),
    ("at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "copies"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("Memset (Device)", "memsets"),
    ("vectorized_elementwise_kernel", "other (elementwise, reductions)")])
def test_kernel_groups(name, group):
    assert profiling.kernel_group(name) == group
    assert profiling.device_time_by_group([(name, 1.5), (name, 2.0)]) == {group: 3.5}


def test_device_memory_stats_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == [{"device": "cpu"}]
