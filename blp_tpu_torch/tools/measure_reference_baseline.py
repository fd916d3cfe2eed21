"""Measure the reference implementation's training throughput on this card.

The port's counterpart of the TPU package's
`tools/measure_reference_baseline.py`: the reference's hot path (reference
train.py:343-350: a BertModel forward over 2B descriptions, the [CLS]
projection, TransE scores of the positives and in-batch negatives, the
margin loss, an Adam step at lr 2e-5), step by step as that tool runs it
(B 16, L 32, K 16, dim 128, fp32, 1 warm-up and 3 timed steps), with random
weights.

The card's machine has no `transformers`, so the encoder is `ReferenceBert`,
a rebuild from `torch.nn` alone of the BertModel the reference ran
(transformers 2.4, its requirements.txt) with HF's parameter names, so that
an HF state dict loads into it with strict=True: embeddings (word, position,
token type) then LayerNorm (eps 1e-12) and dropout 0.1; 12 post-LN layers
whose attention is the eager matmul -> softmax -> dropout of that release;
erf GeLU; the pooler, which the reference's forward computes too. It uses
nothing of blp_tpu_torch.models: it measures the reference's path, not the
port's. Matrix products stay in full fp32 (TF32 off).

    python -m blp_tpu_torch.tools.measure_reference_baseline

Writes `--out` (default bench_baseline_torch.json at the repository root,
which blp_tpu_torch/bench.py divides by; bench_baseline.json is the TPU
package's), its `hardware` naming the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, L, K, DIM = 16, 32, 16, 128
STEPS, WARMUP = 3, 1


@dataclasses.dataclass(frozen=True)
class ReferenceBertConfig:
    """transformers.BertConfig()'s defaults, the config the reference tool
    builds its random BertModel from."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pad_token_id: int = 0


class _Embeddings(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            padding_idx=c.pad_token_id)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        x = x + self.position_embeddings(pos)[None]
        return self.dropout(self.LayerNorm(x))


class _SelfAttention(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)
        self.dropout = nn.Dropout(c.attention_probs_dropout_prob)

    def _heads(self, x):
        b, s, _ = x.shape
        return x.view(b, s, self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x, mask_bias):
        q, k, v = (self._heads(f(x)) for f in (self.query, self.key, self.value))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        probs = self.dropout(torch.softmax(scores + mask_bias, dim=-1))
        ctx = torch.matmul(probs, v).transpose(1, 2)
        return ctx.reshape(x.shape)


class _DenseNorm(nn.Module):
    """dense -> dropout -> LayerNorm(. + residual): HF's BertSelfOutput and
    BertOutput."""

    def __init__(self, c: ReferenceBertConfig, width_in: int):
        super().__init__()
        self.dense = nn.Linear(width_in, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class _Attention(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseNorm(c, c.hidden_size)

    def forward(self, x, mask_bias):
        return self.output(self.self(x, mask_bias), x)


class _Intermediate(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))      # the erf form


class _Layer(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c, c.intermediate_size)

    def forward(self, x, mask_bias):
        a = self.attention(x, mask_bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x, mask_bias):
        for layer in self.layer:
            x = layer(x, mask_bias)
        return x


class _Pooler(nn.Module):
    def __init__(self, c: ReferenceBertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class ReferenceBert(nn.Module):
    """HF BertModel's forward (eager attention, post-LN, erf GeLU, pooler)
    under its parameter names. forward(input_ids, attention_mask) ->
    (last_hidden_state, pooler_output), as BertModel's [0] and [1]."""

    def __init__(self, config: ReferenceBertConfig = ReferenceBertConfig()):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.pooler = _Pooler(config)
        self.apply(self._init_weights)

    def _init_weights(self, m):
        """HF's BertPreTrainedModel._init_weights."""
        std = self.config.initializer_range
        if isinstance(m, nn.Linear):
            m.weight.data.normal_(0.0, std)
            m.bias.data.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.data.normal_(0.0, std)
            if m.padding_idx is not None:
                m.weight.data[m.padding_idx].zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()

    def forward(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        # (1 - mask) * -10000 over the keys, as transformers 2.4 built it.
        mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        h = self.encoder(self.embeddings(input_ids), mask_bias)
        return h, self.pooler(h)


def parse_args(argv: list[str] | None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "bench_baseline_torch.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None, *,
         config: ReferenceBertConfig = ReferenceBertConfig(),
         steps: int = STEPS, warmup: int = WARMUP) -> dict:
    """Time the reference's step and write `--out`. `config`, `steps` and
    `warmup` let a test run a small encoder for one step; the tool's
    command runs the reference's."""
    args = parse_args(argv)

    from blp_tpu_torch.utils import card_stats, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    torch.manual_seed(0)
    encoder = ReferenceBert(config).to(device)
    proj = nn.Linear(config.hidden_size, DIM, bias=False).to(device)
    rel_emb = nn.Embedding(16, DIM).to(device)
    model_params = (list(encoder.parameters()) + list(proj.parameters())
                    + list(rel_emb.parameters()))
    opt = torch.optim.Adam(model_params, lr=2e-5)

    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(1, min(28996, config.vocab_size),
                                        (2 * B, L))).to(device)
    mask = torch.ones(2 * B, L, device=device)
    rels = torch.from_numpy(rng.integers(0, 16, (B,))).to(device)
    neg_idx = torch.from_numpy(rng.integers(0, 2 * B, (B, K, 2))).to(device)

    def step():
        embs = proj(encoder(tok, attention_mask=mask)[0][:, 0])
        embs = F.normalize(embs, dim=-1)
        ent = embs.view(B, 2, DIM)
        r = rel_emb(rels)
        pos = -(ent[:, 0] + r - ent[:, 1]).abs().sum(-1, keepdim=True)
        flat = embs
        neg = -(flat[neg_idx[..., 0]] + r.unsqueeze(1)
                - flat[neg_idx[..., 1]]).abs().sum(-1)
        loss = F.relu(1 - pos + neg).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.item()

    for _ in range(warmup):
        step()
    t0 = time.time()
    for _ in range(steps):
        step()
    dt = (time.time() - t0) / steps
    card = card_stats(device)
    where = (f"{card['device']}, {card['power_limit']}" if card
             else device.type)
    out = {
        "metric": "train_triples_per_sec",
        "value": B / dt,
        "unit": "triples/s",
        "hardware": f"{where} (torch, reference-equivalent hot path)",
        "config": {"batch": B, "max_len": L, "num_negatives": K,
                   "encoder": "bert-base (random init)", "rel_model": "transe"},
        "sec_per_step": dt,
        **card,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
