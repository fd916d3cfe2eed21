"""The operation counts against figures worked by hand."""

from __future__ import annotations

import math

import pytest

from benchmark import spec
from benchmark.models import bert, dkrl

BENCH = spec.load_benchmark()
BERT = spec.load_config(BENCH, "blp-bert-base")
DKRL = spec.load_config(BENCH, "glove-dkrl")
FP32_ADDS = 33.5e12


def test_bert_base_encoder_weights():
    # 12 x (4 x 768^2 + 2 x 768 x 3072)
    assert bert.encoder_weights(BERT) == 84_934_656


def test_bert_forward_a_full_token():
    # 2 x 84.9M weights + 4 x 64 keys x 768 x 12 layers of attention = 1.72e8 a
    # token, and 2 x 768 x 128 for the projection of the sequence's [CLS].
    flops = bert.forward_flops(BERT, [64])
    assert flops == 64 * (2 * 84_934_656 + 4 * 64 * 768 * 12) + 2 * 768 * 128
    assert flops / 64 == pytest.approx(1.72e8, rel=2e-3)


def test_w5m_train_step_and_encode_chunk():
    # The W5M step: 131,072 tokens x 3 x 1.72e8 = 6.8e13 FLOP with every
    # token real; the 12,288-entity chunk: 786,432 x 1.72e8 = 1.35e14.
    step = bert.train_flops(BERT, [64] * 2048)
    assert step == pytest.approx(6.77e13, rel=2e-3)
    chunk = bert.forward_flops(BERT, [64] * 12288)
    assert chunk == pytest.approx(1.354e14, rel=2e-3)
    # Real lengths only: a shorter row costs less, its attention by the square.
    assert bert.forward_flops(BERT, [32]) == (
        32 * 2 * 84_934_656 + 4 * 768 * 12 * 32 * 32 + 2 * 768 * 128)


def test_dkrl_counts():
    # 2 (2 x 300) 128 a position, then 2 (2 x 128) 128 a pooled position.
    assert dkrl.forward_flops(DKRL, [64]) == 64 * 4 * 300 * 128 + 16 * 4 * 128 * 128
    assert dkrl.forward_flops(DKRL, [9]) == 9 * 4 * 300 * 128 + 3 * 4 * 128 * 128
    assert dkrl.train_flops(DKRL, [9, 64]) == 3 * dkrl.forward_flops(DKRL, [9, 64])


def test_rank_work_of_a_batch():
    # 2 fp32 adds per (query, candidate, dim): 128 queries of a batch of 64
    # against 4,594,485 candidates at d 128 is 1.51e11 adds, 4.49 ms at
    # 33.5e12 adds/s (chip_smoke's 4.695 ms is the same count at 4.8M).
    adds = 2.0 * 128 * 4_594_485 * 128
    assert adds / FP32_ADDS * 1e3 == pytest.approx(4.494, abs=1e-3)
    assert 4.695 == pytest.approx(2.0 * 128 * 4_800_000 * 128 / FP32_ADDS * 1e3, abs=1e-3)


def test_peaks():
    from benchmark.metrics import _common

    assert _common.BF16_FLOPS == 989e12
    assert _common.FP32_ADDS == FP32_ADDS
    assert math.isclose(67e12 / 2, FP32_ADDS)


def test_dropped_ranks_are_never_drawn():
    # glove-dkrl's pipeline drops stopwords and punctuation, GloVe's head:
    # no id among the first `dropped_ranks` comes out, and the words left
    # keep their weights (rank 212 against rank 424: twice as often).
    import torch

    from benchmark import inputs

    tokens = dict(DKRL["tokens"])
    assert tokens["dropped_ranks"] == 211
    desc = {"share_at_cap": 1.0, "min_len": 8, "zipf_exponent": 1.0}
    store = inputs.descriptions(4096, 64, tokens, desc, 12345, torch.device("cpu"))
    ids = store.tok[store.tok > 0]
    assert ids.min() == tokens["first_id"] + 211
    assert ids.max() <= tokens["ranks"]
    cdf = inputs.zipf_cdf(tokens["ranks"], 1.0, "cpu", 211)
    assert float(cdf[210]) == 0.0
    p = torch.diff(cdf)
    assert float(p[210] / p[422]) == pytest.approx(2.0)
