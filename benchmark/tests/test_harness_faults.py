"""A run with its timed path broken underneath comes out not correct: once
for each fault the cell can have (no cell spans chips, so none leaves out
an exchange between them). The harness's look for a chip is skipped: the
runs go through `run.execute` on the CPU."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark import run, spec

FAULTS = [("bert-w5m-train", "unchanged"), ("bert-w5m-train", "half_batch"),
          ("glove-dkrl-w5m-train", "unchanged"), ("glove-dkrl-w5m-train", "half_batch"),
          ("bert-w5m-encode", "half_batch"), ("bert-w5m-encode", "altered"),
          ("bert-w5m-rank", "half_batch"), ("bert-w5m-rank", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(tiny_root, workload, fault):
    out = run.execute(workload, 2**31 + 99, 0.2, False, "cpu", fault=fault,
                      root=tiny_root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", sorted({w for w, _ in FAULTS}))
def test_sound_run_is_correct(tiny_root, workload):
    out = run.execute(workload, 2**31 + 99, 0.2, True, "cpu", root=tiny_root)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "bert-w5m-rank", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
