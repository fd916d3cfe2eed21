"""A tiny copy of the benchmark for CPU runs: the repository's
BENCHMARK.json, configurations, traffic mixes, limits and metric readers,
with widths, graphs and batches cut so that a whole run takes seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _edit(path: Path, **changes):
    data = json.loads(path.read_text())
    for key, value in changes.items():
        node = data
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    path.write_text(json.dumps(data))


def make_tiny_root(dst: Path, *, bert_precision: str = "fp32",
                   published_widths: bool = False) -> Path:
    """A checkout-shaped directory whose cells run on the CPU in seconds;
    with `published_widths` BERT keeps bert-base's widths and depth (the
    precision controls need them: fp8's error grows with depth and width)."""
    bench = dst / "benchmark"
    bench.mkdir(parents=True)
    for d in ("metrics", "configs", "traffic", "limits"):
        shutil.copytree(ROOT / "benchmark" / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "benchmark" / "kernel_layers.json", bench)
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    head = {"blp.dim": 8, "blp.num_relations": 10}
    widths = {} if published_widths else dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64)
    _edit(bench / "configs/blp-bert-base.json", vocab_size=220,
          max_position_embeddings=64, **{"tokens.ranks": 110, "training.remat": 1,
                                         "training.precision": bert_precision},
          **widths, **head)
    _edit(bench / "configs/glove-dkrl.json", word_dim=16, vocab_rows=1001,
          **{"tokens.ranks": 1000}, **head)
    _edit(bench / "traffic/w5m-train.json", batch_size=16, max_len=16, num_negatives=4,
          graph={"entities": 2000, "train_triples": 5000})
    _edit(bench / "traffic/w5m-encode.json", max_len=16, emb_batch_size=64,
          chunks_per_call=2, pad_to=256, check_rows=64, graph={"entities": 2000})
    _edit(bench / "traffic/w5m-rank.json", eval_batch_size=16, tile=1024,
          check_batches=3, graph={"entities": 3000, "test_triples": 100},
          **{"filters.cap": 20})
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """BERT in float32, so a sound run agrees with the reference to round-off."""
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_root_bf16(tmp_path_factory) -> Path:
    """BERT in bf16, as the configuration states it (its control is fp8)."""
    return make_tiny_root(tmp_path_factory.mktemp("tiny_bf16"), bert_precision="bf16")


@pytest.fixture(scope="session")
def wide_root(tmp_path_factory) -> Path:
    """BERT at its published widths in bf16, with a few short rows."""
    root = make_tiny_root(tmp_path_factory.mktemp("wide"), bert_precision="bf16",
                          published_widths=True)
    _edit(root / "benchmark/traffic/w5m-encode.json", emb_batch_size=32,
          chunks_per_call=1, check_rows=32)
    return root


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")
