"""BERT encoder for BLP, in plain PyTorch: inference and the training pass.

Port of blp_tpu/models/bert.py. Parameters are a nested dict of tensors in
the TPU package's layout: (in, out) matrices used as ``x @ W``, the encoder
layers either stacked on a leading (num_layers,) axis or unstacked into a
tuple of per-layer dicts.

Semantics match `transformers.BertModel` (post-LN, erf-GeLU, eps=1e-12,
additive -10000 padding mask, token type 0). In fp32 every product runs in
fp32; set `torch.backends.cuda.matmul.allow_tf32 = False` on the card to keep
it so. With a bf16 `compute_dtype` and `fast_inference`, deterministic
encodes run the inference layer `_encoder_layer_fast`: polynomial GeLU, bf16
logits with f32 softmax statistics, bf16 GEMM outputs into the LayerNorms
(f32 statistics) and, with `fused_attention`, the K2 kernel
(ops/packed_attention.py). The bf16 GEMMs are `torch.matmul` in bf16 (f32
accumulation inside the library, bf16 output), so a bias is added after one
bf16 round where the TPU package adds it before; the difference is one bf16
rounding, inside the bf16 noise class.

Both layers, and the embedding LayerNorm, run their elementwise chains
through ops/fused_layer.py and ops/attn_softmax.py, where XLA fuses them in
the TPU package: F1 (`bias_act`: each GEMM's bias add, with the GeLU after
ffn_in), F2 (`add_layer_norm`: the hidden dropout of the residual branch and
the residual add with its LayerNorm) and F3 (`attn_softmax`: the logits'
scale and mask bias, the softmax and the attention dropout), CUDA kernels on
the card and their plain versions on the CPU. They save only the GEMM
output, the rounded residual sum with its row statistics and the logits,
where the op-by-op chains saved an f32 tensor at every step.

Training (`deterministic=False`) runs the exact layer with dropout at the
TPU package's four sites (embedding output, attention probabilities,
attention output, FFN output) and builds an autograd graph; the inference
path runs under `no_grad`. Each site's mask is a function of a per-site seed
derived from the step's `dropout_seed` and of each element's index in the
site (ops/dropout_rng.py, a counter-based generator): F3 applies the
attention site's, F2 the two hidden sites', and the embedding output's goes
through the site kernel (`_rng_dropout`, the JAX custom_vjp's counterpart);
each evaluates the mask again in its backward, and no mask is stored. The
masks therefore do not depend on the global RNG, so the recomputed forward
of `torch.utils.checkpoint` (`remat`) applies the same masks as the first
one. The weights are cast to the compute dtype inside the graph, so
gradients land on the f32 master weights.

`remat` takes the TPU package's values: True (every layer recomputed), an int
k (the first k layers), "dots" (save the matmul outputs, recompute the rest)
and "names" (save only the tensors tagged q, k, v, ctx and ffn_pre). The two
strings are selective checkpoint policies
(`torch.utils.checkpoint.create_selective_checkpoint_contexts`); a policy
sees aten ops, so "names" tags its five tensors with the custom op
`blp_tpu_torch::checkpoint_name`, a copy the policy recognises. Eager
recomputation re-runs every op of the layer and takes the saved outputs in
place of recomputing the saved ops themselves, so the policies cut the
stash, and "dots" also the GEMMs of the backward's recompute.

Parallel training passes a `Part` (see `Part`): the layer runs its share of
the heads and FFN columns under tensor parallelism (Megatron's column- and
row-parallel pair) and gives each dropout site its block's place in the
site one device sees for the whole batch, so a step split over data, model
or pipeline ranks drops the same elements as the one-device step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from blp_tpu_torch.ops.attn_softmax import attn_softmax
from blp_tpu_torch.ops.fused_layer import add_layer_norm, bias_act, site_dropout
from blp_tpu_torch.ops.fused_layer import poly_gelu  # noqa: F401  (public name)
from blp_tpu_torch.ops.row_gather import gather_rows
from blp_tpu_torch.parallel import comm
from blp_tpu_torch.utils import fold_seed


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
    # Width of the random field behind each dropout mask (32: f32-uniform
    # bernoulli; 16/8: integer threshold compare, see ops/dropout_rng.py).
    dropout_bits: int = 32
    initializer_range: float = 0.02
    compute_dtype: Any = torch.float32
    # False | True (every layer under torch.utils.checkpoint) | <int k> (the
    # first k layers) | "dots" | "names" (every layer, under a selective
    # policy; see the module doc).
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


def _rng_dropout(x, seed: int, rate: float, nbits: int = 32, block=None):
    """Dropout of the site (seed, rate, nbits, block) that no fused kernel
    takes: the site kernel (ops/fused_layer.py `site_dropout`), which saves
    nothing and evaluates the mask again in the backward (the TPU package's
    `_rng_dropout` custom_vjp)."""
    return site_dropout(x, (seed, rate, nbits, block))


@dataclasses.dataclass(frozen=True)
class Part:
    """Where one process's share of an encoder call sits in the call one
    device would make for the whole batch.

    rows: (first row, rows of the whole batch), or None when the process
      holds every row. `bert_encode` takes it in sequences; the layers in
      packed rows (it divides by the pack).
    model: the "model" axis (parallel/comm.py `Axis`) under tensor
      parallelism, or None. The process then holds its share of q/k/v and
      ffn_in columns and of attn_out and ffn_out rows (parallel/mesh.py).
    """
    rows: tuple[int, int] | None = None
    model: Any = None

    def block(self, x, heads: int | None = None):
        """(whole shape, start) of x's block of its dropout site: the site's
        shape and the index of x's first element along each dimension (its
        first row, and its first head), or None when x is the whole site.
        `heads`: the whole site's head count, for the attention
        probabilities (B, heads, S, S) under tensor parallelism."""
        start, whole = [0] * x.dim(), list(x.shape)
        if self.rows is not None:
            start[0], whole[0] = self.rows
        if heads is not None and self.model is not None:
            start[1], whole[1] = self.model.rank * x.shape[1], heads
        if tuple(whole) == tuple(x.shape):
            return None
        return tuple(whole), tuple(start)


@torch.library.custom_op("blp_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of x that the "names" remat policy saves (the counterpart of
    jax.ad_checkpoint.checkpoint_name; a custom op may not return its
    input, hence the copy)."""
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))

#: The aten ops "dots" saves: every matmul torch.matmul lowers to.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})
_NAME_OPS = frozenset({torch.ops.blp_tpu_torch.checkpoint_name.default})


def _policy(saved):
    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


#: remat string -> checkpoint context_fn.
_REMAT_POLICIES = {"dots": _policy(_DOT_OPS), "names": _policy(_NAME_OPS)}


def _matmul(x, w, dtype):
    """x @ w in `dtype`: f32 products in f32; bf16 operands through the bf16
    GEMM (f32 accumulation, bf16 output)."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def _dense(x, w, b, dtype, out_dtype=None, model=None, act: str = "none"):
    """Matmul in `dtype`, then F1: the bias in f32 and the activation `act`
    ("none", "erf" or "poly"); `out_dtype` (default f32) is the dtype carried
    forward. `model`: the tensor-parallel axis of a row-parallel product,
    whose f32 partial products are summed over it before the bias is added
    once."""
    out = _matmul(x, w, dtype)
    if model is not None:
        out = comm.reduce_from(out.to(torch.float32), model)
    return bias_act(out, b, act, out_dtype or torch.float32)


def _head_major(x, w, b, hd: int, dt):
    """(B, S, H) @ (H, nh*hd) + b -> (B, nh, S, hd) in dt (the TPU package's
    head-major projection einsum "bsh,hnd->bnsd"): F1 writes the head-major
    layout itself, so no transpose copy follows, and its backward turns the
    cotangent back into rows."""
    return bias_act(_matmul(x, w, dt), b, "none", dt, head_dim=hd)


def _encoder_layer_fast(cfg: BertConfig, x, mask_arg, lp: dict):
    """Inference post-LN layer for a bf16 compute dtype (see module doc).

    mask_arg: (mask_bias, packed_key_mask, segment_len) — the fused kernel
    uses the key mask and segment length; the einsum path the bias."""
    mask_bias, key_mask, seg = mask_arg
    B, S, H = x.shape
    hd = cfg.head_dim
    dt = cfg.compute_dtype

    q = _head_major(x, lp["q_w"], lp["q_b"], hd, dt)
    k = _head_major(x, lp["k_w"], lp["k_b"], hd, dt)
    v = _head_major(x, lp["v_w"], lp["v_b"], hd, dt)
    if cfg.fused_attention:
        from blp_tpu_torch.ops import packed_attention

        ctx = packed_attention.block_diag_attention(
            q, k, v, key_mask, seg=seg, scale=1.0 / math.sqrt(hd)).to(dt)
    else:
        # F3's inference variant: bf16 logits (-10000 rounds to -9984, still
        # a hard mask), f32 softmax statistics.
        probs = attn_softmax(torch.matmul(q, k.transpose(-1, -2)), mask_bias,
                             math.sqrt(hd), dt, round_logits=True)
        ctx = torch.matmul(probs, v)                         # (B, nh, S, hd)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, H)

    attn_out = _dense(ctx, lp["attn_out_w"], lp["attn_out_b"], dt, dt)
    x = add_layer_norm(x, attn_out, lp["attn_ln_scale"], lp["attn_ln_bias"],
                       cfg.layer_norm_eps, dt)
    ffn = _dense(x, lp["ffn_in_w"], lp["ffn_in_b"], dt, dt, act="poly")
    ffn = _dense(ffn, lp["ffn_out_w"], lp["ffn_out_b"], dt, dt)
    return add_layer_norm(x, ffn, lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                          cfg.layer_norm_eps, dt)


def _use_fast_inference(cfg: BertConfig) -> bool:
    return cfg.fast_inference and cfg.compute_dtype != torch.float32


def _encoder_layer(cfg: BertConfig, x, mask_bias, lp: dict, seeds=None,
                   rate: float = 0.0, part: Part | None = None,
                   names: bool = False):
    """One post-LN transformer layer (the exact layer). x: (B, S, H);
    mask_bias: additive attention bias broadcastable to (B, nh, S, S);
    seeds: the layer's three dropout-site seeds (attention probabilities,
    attention output, FFN output), None for no dropout; rate: the hidden
    dropout rate; part: this process's share of the call (`Part`, training
    only); names: tag q, k, v, ctx and ffn_pre for the "names" policy."""
    B, S, H = x.shape
    hd = cfg.head_dim
    nh = lp["q_w"].shape[-1] // hd        # this process's heads
    dt = cfg.compute_dtype
    res_dt = None if dt == torch.float32 else dt
    mp = cfg.mixed_precision_train and dt != torch.float32
    part = part or Part()
    model = part.model
    tag = _checkpoint_name if names else (lambda t, name: t)
    if model is not None:
        # Megatron's f: identity forward, gradient summed over "model".
        xin = comm.copy_to(x, model)
    else:
        xin = x

    if mp:
        q = _head_major(xin, lp["q_w"], lp["q_b"], hd, dt)
        k = _head_major(xin, lp["k_w"], lp["k_b"], hd, dt)
        v = _head_major(xin, lp["v_w"], lp["v_b"], hd, dt)
    else:
        q, k, v = (_dense(xin, lp[f"{n}_w"], lp[f"{n}_b"], dt, dt)
                   .reshape(B, S, nh, hd).permute(0, 2, 1, 3)
                   for n in ("q", "k", "v"))
    q, k, v = tag(q, "q"), tag(k, "k"), tag(v, "v")
    logits = _matmul(q, k.transpose(-1, -2), dt)
    drop = None
    if seeds is not None and cfg.attention_dropout > 0.0:
        drop = (seeds[0], cfg.attention_dropout, cfg.dropout_bits,
                part.block(logits, heads=cfg.num_heads))
    # F3. With mp the bf16 cast the ctx product needs anyway comes before
    # the dropout, as in the TPU package's mixed-precision layer.
    probs = attn_softmax(logits, mask_bias, math.sqrt(hd),
                         dt if mp else torch.float32, dropout=drop)
    ctx = _matmul(probs, v, dt).to(torch.float32)            # (B, nh, S, hd)
    ctx = tag(ctx.permute(0, 2, 1, 3).reshape(B, S, nh * hd), "ctx")

    od = dt if mp else None
    attn_out = _dense(ctx, lp["attn_out_w"], lp["attn_out_b"], dt, od, model)

    def hidden_drop(r, site: int):
        # F2 takes the hidden sites' dropout of its residual branch.
        if seeds is None or rate <= 0.0:
            return None
        return seeds[site], rate, cfg.dropout_bits, part.block(r)

    x = add_layer_norm(x, attn_out, lp["attn_ln_scale"], lp["attn_ln_bias"],
                       cfg.layer_norm_eps, res_dt,
                       dropout=hidden_drop(attn_out, 1))
    xin = comm.copy_to(x, model) if model is not None else x
    act = "poly" if cfg.fast_train and dt != torch.float32 else "erf"
    if names:
        # ffn_pre is the biased, rounded pre-activation, as the TPU package
        # tags it: F1's bias add, the tag, then F1's activation.
        pre = tag(_dense(xin, lp["ffn_in_w"], lp["ffn_in_b"], dt, dt), "ffn_pre")
        ffn = bias_act(pre, None, act, dt)
    else:
        ffn = _dense(xin, lp["ffn_in_w"], lp["ffn_in_b"], dt, dt, act=act)
    ffn = _dense(ffn, lp["ffn_out_w"], lp["ffn_out_b"], dt, od, model)
    return add_layer_norm(x, ffn, lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                          cfg.layer_norm_eps, res_dt,
                          dropout=hidden_drop(ffn, 2))


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
    x = gather_rows(emb["word"], input_ids)
    x = x + emb["position"][:S][None, :, :]
    x = x + emb["token_type"][0][None, None, :]
    x = add_layer_norm(x, None, emb["ln_scale"], emb["ln_bias"],
                       cfg.layer_norm_eps, res_dt)

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


def _remat_layers(cfg: BertConfig) -> int:
    """How many leading layers run under torch.utils.checkpoint: an int k
    takes the first k, any other true value (True, a policy string) every
    layer — the TPU package's `remat_k` rule."""
    if isinstance(cfg.remat, str) and cfg.remat not in _REMAT_POLICIES:
        raise ValueError(f"remat={cfg.remat!r}: expected False, True, a layer "
                         f"count or one of {sorted(_REMAT_POLICIES)}")
    if not cfg.remat:
        return 0
    if isinstance(cfg.remat, int) and not isinstance(cfg.remat, bool):
        return int(cfg.remat)
    return cfg.num_layers


def bert_encode(params: dict, input_ids, attention_mask, cfg: BertConfig, *,
                deterministic: bool = True, dropout_seed: int | None = None,
                part: Part | None = None):
    """Run the encoder. Returns the last hidden states (B, S, H) in the
    residual dtype: float32 in fp32 mode, compute_dtype otherwise.

    attention_mask: (B, S), 1 for real tokens (None = all ones). Stacked and
    unstacked `layers` layouts both run. deterministic=True is inference,
    under no_grad. deterministic=False is the training pass: dropout from
    `dropout_seed` (an int; required), an autograd graph, and `cfg.remat`.
    part: this process's share of a parallel training pass (`Part`, rows in
    sequences); the pack must then divide this process's rows.
    """
    if not deterministic and dropout_seed is None:
        raise ValueError("dropout_seed required when deterministic=False")
    grad_ctx = torch.no_grad() if deterministic else contextlib.nullcontext()
    with grad_ctx:
        return _bert_encode(params, input_ids, attention_mask, cfg,
                            None if deterministic else dropout_seed, part)


def layer_seeds(dropout_seed: int, layer: int) -> tuple[int, int, int]:
    """The three dropout-site seeds of encoder layer `layer` (its global
    index) in the training pass seeded by `dropout_seed`."""
    layer_seed = fold_seed(dropout_seed, 1)
    return tuple(fold_seed(layer_seed, 3 * layer + j) for j in range(3))


def embed_dropout(x, dropout_seed: int, cfg: BertConfig, part: Part | None):
    """The embedding output's dropout site of the training pass (x packed,
    `part` in packed rows)."""
    if cfg.hidden_dropout <= 0.0:
        return x
    return _rng_dropout(x, fold_seed(dropout_seed, 0), cfg.hidden_dropout,
                        cfg.dropout_bits, (part or Part()).block(x))


def run_layer(cfg: BertConfig, x, mask_bias, lp: dict, seeds, *,
              part: Part | None = None, remat: bool = False):
    """One exact layer of the training pass, under `cfg.remat`'s checkpoint
    policy when `remat`."""
    fn = functools.partial(_encoder_layer, cfg, mask_bias=mask_bias, lp=lp,
                           seeds=seeds, rate=cfg.hidden_dropout, part=part,
                           names=remat and cfg.remat == "names")
    if not remat:
        return fn(x)
    policy = _REMAT_POLICIES.get(cfg.remat) if isinstance(cfg.remat, str) else None
    kw = {} if policy is None else {"context_fn": policy}
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False, **kw)


def _bert_encode(params, input_ids, attention_mask, cfg: BertConfig,
                 dropout_seed, part: Part | None = None):
    B, S = input_ids.shape
    x, mask_bias, pack, key_mask = embed_inputs(params, input_ids,
                                                attention_mask, cfg)
    layers = params["layers"]
    if not isinstance(layers, (tuple, list)):
        layers = unstack_layers(params)["layers"]

    if dropout_seed is None:
        if _use_fast_inference(cfg):
            mask_arg = (mask_bias, key_mask, S)
            for lp in layers:
                x = _encoder_layer_fast(cfg, x, mask_arg, lp)
        else:
            for lp in layers:
                x = _encoder_layer(cfg, x, mask_bias, lp)
        return x.reshape(B, S, x.shape[-1]) if pack > 1 else x

    if part is not None and part.rows is not None:
        start, total = part.rows
        if start % pack or total % pack:
            raise ValueError(f"rows {part.rows} do not divide by the pack {pack}")
        part = dataclasses.replace(part, rows=(start // pack, total // pack))
    x = embed_dropout(x, dropout_seed, cfg, part)
    remat_k = _remat_layers(cfg) if torch.is_grad_enabled() else 0
    for i, lp in enumerate(layers):
        x = run_layer(cfg, x, mask_bias, lp, layer_seeds(dropout_seed, i),
                      part=part, remat=i < remat_k)
    return x.reshape(B, S, x.shape[-1]) if pack > 1 else x


def bert_pooler(params: dict, hidden, cfg: BertConfig):
    """HF pooler: tanh(dense([CLS])). BLP does not use it; it is kept for
    checkpoint round-trips and downstream users."""
    return torch.tanh(_dense(hidden[:, 0], params["pooler"]["w"],
                             params["pooler"]["b"], cfg.compute_dtype))


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


def config_from_hf(hf_config) -> BertConfig:
    """A BertConfig from a transformers BertConfig, or any object with its
    attribute names (only attributes are read, so no transformers import)."""
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
        initializer_range=hf_config.initializer_range,
    )
