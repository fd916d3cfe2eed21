"""Word-embedding description encoders: BOW and the DKRL CNN.

Port of blp_tpu/models/encoders.py: plain functions on tensors, run where
their arguments live. L is the dataset's static max_len and padding is
handled by masks. The DKRL convolutions are one matmul each over a
shifted-concat layout, as in the TPU package.

Static-shape note (the TPU package's documented deviation from the
reference, kept): the reference truncates each batch to its longest
description and its max_pool1d(kernel=4) then drops the trailing Lb % 4
positions of the longest one; with a static L that is a multiple of 4 no
real position is dropped.

The max-pool uses `amax`, whose gradient splits evenly among tied maxima,
as JAX's `max` reduction does (`max(dim).values` would send it to one
index). A window ties whenever a real position's conv output is exactly 0
next to masked zeros.
"""

from __future__ import annotations

import torch

from blp_tpu_torch.ops.row_gather import gather_rows


def bow_encode(word_embeddings, text_tok, text_mask):
    """Masked mean of word embeddings.

    word_embeddings: (V, E); text_tok: (B, L) int ids; text_mask: (B, L)
    1/0, or None for all ones. Returns (B, E) float32.
    """
    if text_mask is None:
        text_mask = torch.ones(text_tok.shape, device=text_tok.device)
    text_mask = text_mask.to(torch.float32)
    embs = gather_rows(word_embeddings, text_tok)            # (B, L, E)
    lengths = text_mask.sum(-1, keepdim=True)
    summed = torch.einsum("bl,ble->be", text_mask, embs)
    return summed / lengths


def init_dkrl_params(generator: torch.Generator, emb_dim: int, dim: int) -> dict:
    """Two width-2 conv layers stored pre-flattened as (2·in, out) matmul
    weights. torch Conv1d's default init: U(-b, b) with b = 1/sqrt(2·in)
    for weights and biases alike. Drawn from `generator`, on its device."""
    b1 = 1.0 / (2.0 * emb_dim) ** 0.5
    b2 = 1.0 / (2.0 * dim) ** 0.5

    def uniform(shape, bound):
        t = torch.empty(shape, device=generator.device)
        return t.uniform_(-bound, bound, generator=generator)

    return {
        "conv1_w": uniform((2 * emb_dim, dim), b1),
        "conv1_b": uniform((dim,), b1),
        "conv2_w": uniform((2 * dim, dim), b2),
        "conv2_b": uniform((dim,), b2),
    }


def _conv_k2_same_right(x, w, b):
    """Width-2 'valid conv after right-pad-1' as one matmul:
    out[l] = [x[l]; x[l+1]] @ w + b with x[L] = 0. x: (B, L, C) ->
    (B, L, out)."""
    x_next = torch.cat([x[:, 1:, :], torch.zeros_like(x[:, :1, :])], dim=1)
    stacked = torch.cat([x, x_next], dim=-1)                 # (B, L, 2C)
    return torch.matmul(stacked, w) + b


def dkrl_encode(params: dict, word_embeddings, text_tok, text_mask, *,
                pool: int = 4):
    """DKRL CNN encoder:

    emb -> mask -> conv1(k=2, right-pad) -> mask -> maxpool(4) -> tanh
        -> conv2(k=2, right-pad) -> masked mean over pooled positions -> tanh

    Requires L divisible by `pool` (the standard max_len 32 and 64 are).
    """
    B, L = text_tok.shape
    if L % pool != 0:
        raise ValueError(f"DKRL requires seq len divisible by {pool}, got {L}")
    if text_mask is None:
        text_mask = torch.ones((B, L), device=text_tok.device)
    text_mask = text_mask.to(torch.float32)

    embs = gather_rows(word_embeddings, text_tok) * text_mask[..., None]  # (B, L, E)

    h = _conv_k2_same_right(embs, params["conv1_w"], params["conv1_b"])
    h = h * text_mask[..., None]

    # Non-overlapping max pool, stride == kernel == pool.
    h = h.reshape(B, L // pool, pool, -1).amax(dim=2)
    pooled_mask = text_mask.reshape(B, L // pool, pool).amax(dim=2)
    h = torch.tanh(h)

    h = _conv_k2_same_right(h, params["conv2_w"], params["conv2_b"])
    lengths = pooled_mask.sum(-1, keepdim=True)
    h = torch.einsum("bl,bld->bd", pooled_mask, h) / lengths
    return torch.tanh(h)


def init_entity_table(generator: torch.Generator, num_entities: int,
                      dim: int):
    """Transductive entity lookup table, xavier-uniform, drawn from
    `generator` on its device."""
    bound = (6.0 / (num_entities + dim)) ** 0.5
    t = torch.empty((num_entities, dim), device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)
