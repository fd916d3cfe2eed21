"""BERT encoder for BLP inference, in plain PyTorch.

Port of blp_tpu/models/bert.py, deterministic (inference) only. Parameters
are a nested dict of tensors in the TPU package's layout: (in, out) matrices
used as ``x @ W``, the encoder layers either stacked on a leading
(num_layers,) axis or unstacked into a tuple of per-layer dicts.

Semantics match `transformers.BertModel` (post-LN, erf-GeLU, eps=1e-12,
additive -10000 padding mask, token type 0). In fp32 every product runs in
fp32; set `torch.backends.cuda.matmul.allow_tf32 = False` on the card to keep
it so. With a bf16 `compute_dtype` and `fast_inference`, the inference layer
`_encoder_layer_fast` runs: polynomial GeLU, bf16 logits with f32 softmax
statistics, bf16 GEMM outputs into the LayerNorms (f32 statistics) and, with
`fused_attention`, the K2 kernel (ops/packed_attention.py). The bf16 GEMMs
are `torch.matmul` in bf16 (f32 accumulation inside the library, bf16
output), so a bias is added after one bf16 round where the TPU package adds
it before; the difference is one bf16 rounding, inside the bf16 noise class.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996  # bert-base-cased
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # Training keys (dropout mask width, rematerialisation): accepted for
    # config parity, used by the training slice.
    dropout_bits: int = 32
    initializer_range: float = 0.02
    compute_dtype: Any = torch.float32
    remat: Any = False
    # Sequence packing: fold `pack` sequences into one row with a
    # block-diagonal attention mask. Exact (-10000 cross-block bias
    # underflows to exactly 0 in the softmax; FFN and LN are per token).
    # "auto" picks the largest pack <= 4 with pack*S <= 128 dividing the
    # batch; 1 disables.
    seq_pack: Any = "auto"
    mixed_precision_train: bool = True
    fast_train: bool = False
    # bf16 deterministic encodes take _encoder_layer_fast (see module doc).
    fast_inference: bool = True
    # K2, the packed-attention kernel, inside _encoder_layer_fast.
    fused_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Small config for tests and dry-runs."""
        base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position_embeddings=64)
        base.update(kw)
        return BertConfig(**base)


def init_bert_params(cfg: BertConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Truncated-normal(initializer_range) init, layers stacked on a leading
    (num_layers,) axis. The numbers come from `generator` (a CPU generator
    gives the same weights on every device)."""
    std = cfg.initializer_range
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    gen_device = generator.device

    def tn(*shape):
        t = torch.empty(shape, device=gen_device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return t.to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "embeddings": {
            "word": tn(cfg.vocab_size, H),
            "position": tn(cfg.max_position_embeddings, H),
            "token_type": tn(cfg.type_vocab_size, H),
            "ln_scale": ones(H),
            "ln_bias": zeros(H),
        },
        "layers": {
            "q_w": tn(L, H, H), "q_b": zeros(L, H),
            "k_w": tn(L, H, H), "k_b": zeros(L, H),
            "v_w": tn(L, H, H), "v_b": zeros(L, H),
            "attn_out_w": tn(L, H, H), "attn_out_b": zeros(L, H),
            "attn_ln_scale": ones(L, H), "attn_ln_bias": zeros(L, H),
            "ffn_in_w": tn(L, H, I), "ffn_in_b": zeros(L, I),
            "ffn_out_w": tn(L, I, H), "ffn_out_b": zeros(L, H),
            "ffn_ln_scale": ones(L, H), "ffn_ln_bias": zeros(L, H),
        },
        "pooler": {"w": tn(H, H), "b": zeros(H)},
    }


def unstack_layers(bert_params: dict) -> dict:
    """Stacked (num_layers, ...) layer tree -> tuple of per-layer dicts
    (views, no copy). No-op if already unstacked."""
    layers = bert_params["layers"]
    if isinstance(layers, (tuple, list)):
        return bert_params
    n = next(iter(layers.values())).shape[0]
    out = dict(bert_params)
    out["layers"] = tuple({k: v[i] for k, v in layers.items()}
                          for i in range(n))
    return out


def restack_layers(bert_params: dict) -> dict:
    """Inverse of unstack_layers (no-op if already stacked)."""
    layers = bert_params["layers"]
    if not isinstance(layers, (tuple, list)):
        return bert_params
    out = dict(bert_params)
    out["layers"] = {k: torch.stack([lp[k] for lp in layers])
                     for k in layers[0]}
    return out


def _layer_norm(x, scale, bias, eps: float, out_dtype=None):
    """LayerNorm with float32 statistics; `out_dtype` is the dtype the
    residual stream is carried in."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * scale + bias
    return out.to(out_dtype) if out_dtype is not None else out


def _matmul(x, w, dtype):
    """x @ w in `dtype`: f32 products in f32; bf16 operands through the bf16
    GEMM (f32 accumulation, bf16 output)."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def _dense(x, w, b, dtype, out_dtype=None):
    """Matmul in `dtype` plus the bias in f32; `out_dtype` (default f32) is
    the dtype carried forward."""
    out = _matmul(x, w, dtype).to(torch.float32) + b
    return out.to(out_dtype) if out_dtype is not None else out


# Degree-6 minimax fit of Phi(x) - 0.5 as x * p(x^2) on [0, 4] (Phi = the
# exact-GeLU gaussian CDF). Max abs error of the resulting GeLU is 4.2e-4 on
# the fitted range; |x| is clamped to 4 for the polynomial argument and the
# ORIGINAL x multiplies Phi, so large activations pass through with relative
# error <= 3.2e-5 (= 1 - Phi(4)). Same coefficients as the TPU package.
_POLY_GELU_C = (0.3985269463542832, -0.06538842792339565, 0.009112993720802636,
                -0.0008789911715555882, 5.4191581420189626e-05,
                -1.8919542111355878e-06, 2.816234526830968e-08)


def poly_gelu(x):
    """Exact-GeLU (erf) to beyond-bf16 accuracy through the polynomial above;
    evaluated in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    xc = torch.clamp(xf, -4.0, 4.0)
    u = xc * xc
    p = torch.full_like(u, _POLY_GELU_C[6])
    for c in _POLY_GELU_C[5::-1]:
        p = p * u + c
    phi = torch.clamp(0.5 + xc * p, 0.0, 1.0)
    return (xf * phi).to(x.dtype)


def _head_major(x, w, b, nh: int, hd: int, dt):
    """(B, S, H) @ (H, nh*hd) + b -> (B, nh, S, hd) in dt (the TPU package's
    head-major projection einsum "bsh,hnd->bnsd")."""
    B, S, _ = x.shape
    out = _matmul(x, w, dt).to(torch.float32) + b
    return out.reshape(B, S, nh, hd).permute(0, 2, 1, 3).to(dt).contiguous()


def _encoder_layer_fast(cfg: BertConfig, x, mask_arg, lp: dict):
    """Inference post-LN layer for a bf16 compute dtype (see module doc).

    mask_arg: (mask_bias, packed_key_mask, segment_len) — the fused kernel
    uses the key mask and segment length; the einsum path the bias."""
    mask_bias, key_mask, seg = mask_arg
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    dt = cfg.compute_dtype

    q = _head_major(x, lp["q_w"], lp["q_b"], nh, hd, dt)
    k = _head_major(x, lp["k_w"], lp["k_b"], nh, hd, dt)
    v = _head_major(x, lp["v_w"], lp["v_b"], nh, hd, dt)
    if cfg.fused_attention:
        from blp_tpu_torch.ops import packed_attention

        ctx = packed_attention.block_diag_attention(
            q, k, v, key_mask, seg=seg, scale=1.0 / math.sqrt(hd)).to(dt)
    else:
        logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
        # bf16 logits; -10000 rounds to -9984, still a hard mask. Softmax
        # statistics stay f32.
        logits = (logits / math.sqrt(hd) + mask_bias).to(torch.bfloat16)
        m = logits.amax(dim=-1, keepdim=True).to(torch.float32)
        e = torch.exp(logits.to(torch.float32) - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        ctx = torch.matmul(probs.to(dt), v)                  # (B, nh, S, hd)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, H)

    attn_out = _dense(ctx, lp["attn_out_w"], lp["attn_out_b"], dt, dt)
    x = _layer_norm(x + attn_out, lp["attn_ln_scale"], lp["attn_ln_bias"],
                    cfg.layer_norm_eps, out_dtype=dt)
    ffn = _dense(x, lp["ffn_in_w"], lp["ffn_in_b"], dt, dt)
    ffn = poly_gelu(ffn)
    ffn = _dense(ffn, lp["ffn_out_w"], lp["ffn_out_b"], dt, dt)
    return _layer_norm(x + ffn, lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                       cfg.layer_norm_eps, out_dtype=dt)


def _use_fast_inference(cfg: BertConfig) -> bool:
    return cfg.fast_inference and cfg.compute_dtype != torch.float32


def _encoder_layer(cfg: BertConfig, x, mask_bias, lp: dict):
    """One post-LN transformer layer (the exact layer, deterministic).
    x: (B, S, H); mask_bias: additive attention bias broadcastable to
    (B, nh, S, S)."""
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    dt = cfg.compute_dtype
    res_dt = None if dt == torch.float32 else dt
    mp = cfg.mixed_precision_train and dt != torch.float32

    if mp:
        q = _head_major(x, lp["q_w"], lp["q_b"], nh, hd, dt)
        k = _head_major(x, lp["k_w"], lp["k_b"], nh, hd, dt)
        v = _head_major(x, lp["v_w"], lp["v_b"], nh, hd, dt)
    else:
        q, k, v = (_dense(x, lp[f"{n}_w"], lp[f"{n}_b"], dt, dt)
                   .reshape(B, S, nh, hd).permute(0, 2, 1, 3)
                   for n in ("q", "k", "v"))
    logits = _matmul(q, k.transpose(-1, -2), dt).to(torch.float32)
    logits = logits / math.sqrt(hd) + mask_bias
    probs = torch.softmax(logits, dim=-1)
    ctx = _matmul(probs, v, dt).to(torch.float32)            # (B, nh, S, hd)
    ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, H)

    od = dt if mp else None
    attn_out = _dense(ctx, lp["attn_out_w"], lp["attn_out_b"], dt, od)
    x = _layer_norm(x + attn_out, lp["attn_ln_scale"], lp["attn_ln_bias"],
                    cfg.layer_norm_eps, out_dtype=res_dt)
    ffn = _dense(x, lp["ffn_in_w"], lp["ffn_in_b"], dt, dt)
    if cfg.fast_train and dt != torch.float32:
        ffn = poly_gelu(ffn)
    else:
        ffn = F.gelu(ffn)
    ffn = _dense(ffn, lp["ffn_out_w"], lp["ffn_out_b"], dt, od)
    return _layer_norm(x + ffn, lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                       cfg.layer_norm_eps, out_dtype=res_dt)


def embed_inputs(params: dict, input_ids, attention_mask, cfg: BertConfig):
    """Token + position + segment-0 embeddings, LayerNorm, optional sequence
    packing, additive attention bias.

    Returns (x, mask_bias, pack, packed_key_mask): x is (B/pack, pack*S, H)
    in the residual dtype; mask_bias the additive bias broadcastable to
    (B/pack, heads, pack*S, pack*S); packed_key_mask the (B/pack, pack*S)
    key mask the fused kernel rebuilds the bias from."""
    B, S = input_ids.shape
    emb = params["embeddings"]
    res_dt = None if cfg.compute_dtype == torch.float32 else cfg.compute_dtype
    x = emb["word"][input_ids.long()]
    x = x + emb["position"][:S][None, :, :]
    x = x + emb["token_type"][0][None, None, :]
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps,
                    out_dtype=res_dt)

    pack = cfg.seq_pack
    if pack == "auto":
        pack = next((p for p in (4, 2) if B % p == 0 and p * S <= 128), 1)
    if attention_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    else:
        key_mask = attention_mask.to(torch.float32)
    if pack > 1:
        Bp, Sp = B // pack, pack * S
        x = x.reshape(Bp, Sp, x.shape[-1])
        packed_mask = key_mask.reshape(Bp, Sp)
        idx = torch.arange(Sp, device=x.device) // S
        visible = (idx[:, None] == idx[None, :])[None] & (packed_mask[:, None, :] > 0)
        mask_bias = torch.where(visible, 0.0, -10000.0).to(torch.float32)[:, None]
    else:
        packed_mask = key_mask
        mask_bias = (1.0 - key_mask)[:, None, None, :] * -10000.0
    return x, mask_bias, pack, packed_mask


@torch.no_grad()
def bert_encode(params: dict, input_ids, attention_mask, cfg: BertConfig, *,
                deterministic: bool = True):
    """Run the encoder. Returns the last hidden states (B, S, H) in the
    residual dtype: float32 in fp32 mode, compute_dtype otherwise.

    attention_mask: (B, S), 1 for real tokens (None = all ones). Stacked and
    unstacked `layers` layouts both run. Inference only: deterministic=False
    (dropout) comes with the training slice and raises here.
    """
    if not deterministic:
        raise NotImplementedError(
            "bert_encode supports deterministic=True only in this port "
            "(dropout arrives with the training path)")
    B, S = input_ids.shape
    x, mask_bias, pack, key_mask = embed_inputs(params, input_ids,
                                                attention_mask, cfg)
    if _use_fast_inference(cfg):
        layer_fn = _encoder_layer_fast
        mask_arg = (mask_bias, key_mask, S)
    else:
        layer_fn = _encoder_layer
        mask_arg = mask_bias

    layers = params["layers"]
    if not isinstance(layers, (tuple, list)):
        layers = unstack_layers(params)["layers"]
    for lp in layers:
        x = layer_fn(cfg, x, mask_arg, lp)
    return x.reshape(B, S, x.shape[-1]) if pack > 1 else x


def params_from_hf_state_dict(state_dict: dict, cfg: BertConfig) -> dict:
    """Convert a `transformers.BertModel.state_dict()` (torch tensors or numpy
    arrays, with or without the `bert.` prefix) into this module's
    stacked-layer tree of float32 CPU tensors."""

    def get(name: str) -> torch.Tensor:
        for prefix in ("", "bert."):
            key = prefix + name
            if key in state_dict:
                t = state_dict[key]
                if isinstance(t, torch.Tensor):
                    return t.detach().to("cpu", torch.float32)
                return torch.as_tensor(np.asarray(t, dtype=np.float32))
        raise KeyError(f"Missing parameter {name!r} in state dict")

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        mats = [get(fmt.format(i)) for i in range(cfg.num_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return torch.stack(mats).contiguous()

    p = "encoder.layer.{}."
    return {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": {
            "q_w": stack(p + "attention.self.query.weight", transpose=True),
            "q_b": stack(p + "attention.self.query.bias"),
            "k_w": stack(p + "attention.self.key.weight", transpose=True),
            "k_b": stack(p + "attention.self.key.bias"),
            "v_w": stack(p + "attention.self.value.weight", transpose=True),
            "v_b": stack(p + "attention.self.value.bias"),
            "attn_out_w": stack(p + "attention.output.dense.weight", transpose=True),
            "attn_out_b": stack(p + "attention.output.dense.bias"),
            "attn_ln_scale": stack(p + "attention.output.LayerNorm.weight"),
            "attn_ln_bias": stack(p + "attention.output.LayerNorm.bias"),
            "ffn_in_w": stack(p + "intermediate.dense.weight", transpose=True),
            "ffn_in_b": stack(p + "intermediate.dense.bias"),
            "ffn_out_w": stack(p + "output.dense.weight", transpose=True),
            "ffn_out_b": stack(p + "output.dense.bias"),
            "ffn_ln_scale": stack(p + "output.LayerNorm.weight"),
            "ffn_ln_bias": stack(p + "output.LayerNorm.bias"),
        },
        "pooler": {
            "w": get("pooler.dense.weight").T.contiguous(),
            "b": get("pooler.dense.bias"),
        },
    }
