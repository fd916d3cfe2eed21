"""BLP with the DKRL encoder over a word table: its weights, its operation
counts and its plain reference.

DKRL (Xie et al., AAAI 2016), as BLP's reference `models.py` builds it:
word vectors, masked; a width-2 convolution over positions l and l+1 (the
last position sees a zero), masked; max-pooling over windows of 4; tanh; a
second width-2 convolution; the mean over the pooled positions that hold a
real word; tanh. The reference convolves with `conv1d`; the weights are
kept as (2 * in, out) matrices, the rows for position l first.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.models import common

POOL = 4


def leaves(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(path, shape, init) of every weight (see bert.leaves)."""
    E, V = cfg["word_dim"], cfg["vocab_rows"]
    blp = cfg["blp"]
    R, D = blp["num_relations"], blp["dim"]
    b1, b2 = 1.0 / math.sqrt(2 * E), 1.0 / math.sqrt(2 * D)
    return [("word_emb", (V, E), ("normal", cfg["word_std"])),
            ("dkrl/conv1_w", (2 * E, D), ("uniform", b1)),
            ("dkrl/conv1_b", (D,), ("uniform", b1)),
            ("dkrl/conv2_w", (2 * D, D), ("uniform", b2)),
            ("dkrl/conv2_b", (D,), ("uniform", b2)),
            ("rel_emb", (R, D), ("uniform", math.sqrt(6.0 / (R + D))))]


def layer_leaves(weights: dict) -> dict:
    return dict(weights)


def forward_flops(cfg: dict, lengths) -> float:
    """Forward FLOPs of the two convolutions over the real positions of
    each description: 2 * (2 E) * D a position, then 2 * (2 D) * D a
    pooled position (a pooled position holds up to 4 real words)."""
    E, D = cfg["word_dim"], cfg["blp"]["dim"]
    total = 0.0
    for n in lengths:
        n = int(n)
        total += 4.0 * E * D * n + 4.0 * D * D * (-(-n // POOL))
    return total


def train_flops(cfg: dict, lengths) -> float:
    return 3.0 * forward_flops(cfg, lengths)


def _conv(x, w, b, mode):
    """Width-2 convolution of x (n, L, C) with (2C, D) weights, the last
    position padded with a zero, through conv1d."""
    c = x.shape[-1]
    kernel = torch.stack([w[:c].t(), w[c:].t()], dim=-1)      # (D, C, 2)
    inp = F.pad(common.round_to(x, mode).transpose(1, 2), (0, 1))
    return F.conv1d(inp, common.round_to(kernel, mode), b).transpose(1, 2)


def encode(cfg: dict, weights: dict, tok: torch.Tensor, mask: torch.Tensor, *,
           mode: str = "fp32") -> torch.Tensor:
    """(n, dim) entity rows before normalization."""
    n, L = tok.shape
    m = mask.to(torch.float32)
    x = weights["word_emb"][tok.long()] * m[..., None]
    h = _conv(x, weights["dkrl/conv1_w"], weights["dkrl/conv1_b"], mode)
    h = h * m[..., None]
    h = F.max_pool1d(h.transpose(1, 2), POOL).transpose(1, 2)
    pooled = F.max_pool1d(m[:, None, :], POOL)[:, 0]
    h = torch.tanh(h)
    h = _conv(h, weights["dkrl/conv2_w"], weights["dkrl/conv2_b"], mode)
    h = (h * pooled[..., None]).sum(1) / pooled.sum(1, keepdim=True)
    return torch.tanh(h)


def train_encode(cfg: dict, weights: dict, tok, mask, dropout_seed: int, *,
                 mode: str = "fp32") -> torch.Tensor:
    """The training pass's rows: DKRL has no dropout."""
    del dropout_seed
    return encode(cfg, weights, tok, mask, mode=mode)
