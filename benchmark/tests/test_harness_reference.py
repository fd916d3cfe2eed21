"""The plain reference agrees with the port at tiny widths on the CPU, and
its lower-precision control fails the comparison.

These tests run the port beside the reference (the reference itself
imports nothing of it)."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, run, spec
from benchmark.models import bert, common
from blp_tpu_torch.ops import dropout_rng
from blp_tpu_torch.utils import fold_seed

TRAIN = ("bert-w5m-train", "glove-dkrl-w5m-train")


def test_philox_known_answer():
    # Random123's known answer for Philox4x32-10 at counter 0, key 0.
    words = bert.philox(torch.zeros(1, dtype=torch.int64), 0)[0].tolist()
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_masks_equal_the_port(bits):
    seed = fold_seed(12345, 7)
    shape = (3, 5, 9, 7)
    want, _ = dropout_rng.site_keep(seed, 0.1, bits, shape)
    got = bert.site_keep(seed, shape, 0.1, bits, "cpu", calls_a_block=17)
    assert torch.equal(got, want)


def test_seeds_equal_the_port():
    for seed, data in ((0, 0), (2**31 + 5, 3), (2**62, 2**40)):
        assert common.fold_seed(seed, data) == fold_seed(seed, data)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_reference_follows_the_port(tiny_root, workload):
    """In float32 the program and the reference agree to round-off."""
    out = calibrate.readings(workload, 2**31 + 77, "program", 0.0, device="cpu",
                             root=tiny_root)
    assert out["loss_gap"] < 1e-5 and out["grad_gap"] < 1e-4
    assert out["change_gap"] < 1e-3


def test_encode_reference_follows_the_port(tiny_root_bf16):
    out = calibrate.readings("bert-w5m-encode", 3, "program", 0.2, device="cpu",
                             root=tiny_root_bf16)
    limits = spec.load_limits("bert-w5m-encode", tiny_root_bf16)
    assert 0 < out["row_gap"] <= limits["row_gap"]


def test_rank_reference_counts_exactly(tiny_root):
    out = calibrate.readings("bert-w5m-rank", 2**32 + 1, "program", 0.2,
                             device="cpu", root=tiny_root)
    assert out == {"count_mismatches": 0.0}


@pytest.mark.parametrize("workload", ["bert-w5m-train", "bert-w5m-encode",
                                      "bert-w5m-rank"])
def test_control_fails(wide_root, workload):
    """The reference in the precision below the configuration's (fp8 for
    bf16, at BERT's published widths; bf16 for the rank's float32
    distances) fails the limits."""
    seconds = 0.0 if workload.endswith("train") else 0.05
    out = calibrate.readings(workload, 41, "control", seconds, device="cpu",
                             root=wide_root)
    limits = spec.load_limits(workload, wide_root)
    assert any(out[k] > limits[k] for k in limits), out


@pytest.mark.cuda
def test_dkrl_tf32_control_fails(tiny_root, cuda_device):
    """DKRL states float32: its control is TF32, which only the card has."""
    out = calibrate.readings("glove-dkrl-w5m-train", 43, "control", 0.0,
                             device=cuda_device, root=tiny_root)
    limits = spec.load_limits("glove-dkrl-w5m-train", tiny_root)
    assert any(out[k] > limits[k] for k in limits), out


def test_run_result_shape(tiny_root):
    out = run.execute("glove-dkrl-w5m-train", 9, 0.3, False, "cpu", root=tiny_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_triples_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec.load_limits("glove-dkrl-w5m-train", tiny_root))
