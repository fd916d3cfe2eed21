"""BLP with a BERT encoder: its weights, its operation counts and its plain
reference.

The reference follows `transformers.BertModel` as BLP uses it (Daza et
al. 2021): word + position + segment-0 embeddings and a LayerNorm, post-LN
layers with erf GeLU and eps 1e-12, an additive -10000 padding bias, the
[CLS] row projected to `dim` without a bias. It runs in float32 with TF32
off, or in a control's precision (`common.round_to`).

Where the port's result depends on a documented choice and not on the
model, the reference makes the same choice:

- dropout masks: each site's keep bits are Philox4x32-10 of the site's seed
  and of each element's flat index in the site (`site_keep`), with the
  seeds derived from the step's dropout seed by `common.fold_seed`;
- the index is taken in the packed layout: `pack` sequences share a row of
  pack * L positions with a block-diagonal bias (the largest pack of 4 or 2
  with pack * L <= 128 that divides the batch). Packing itself leaves the
  arithmetic unchanged: a -10000 bias underflows to an exact 0 weight.
"""

from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.models import common

# -- weights -------------------------------------------------------------------


def leaves(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(path, shape, init) of every weight, layers stacked: init is
    ("normal", std), ("uniform", bound), ("ones",) or ("zeros",)."""
    H, I, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    V, P, T = cfg["vocab_size"], cfg["max_position_embeddings"], cfg["type_vocab_size"]
    std = ("normal", cfg["initializer_range"])
    blp = cfg["blp"]
    R, D = blp["num_relations"], blp["dim"]
    out = [("bert/embeddings/word", (V, H), std),
           ("bert/embeddings/position", (P, H), std),
           ("bert/embeddings/token_type", (T, H), std),
           ("bert/embeddings/ln_scale", (H,), ("ones",)),
           ("bert/embeddings/ln_bias", (H,), ("zeros",))]
    for name, shape in (("q", (H, H)), ("k", (H, H)), ("v", (H, H)),
                        ("attn_out", (H, H)), ("ffn_in", (H, I)),
                        ("ffn_out", (I, H))):
        out.append((f"bert/layers/{name}_w", (L, *shape), std))
        out.append((f"bert/layers/{name}_b", (L, shape[1]), ("zeros",)))
    for ln in ("attn_ln", "ffn_ln"):
        out.append((f"bert/layers/{ln}_scale", (L, H), ("ones",)))
        out.append((f"bert/layers/{ln}_bias", (L, H), ("zeros",)))
    out += [("bert/pooler/w", (H, H), std), ("bert/pooler/b", (H,), ("zeros",)),
            ("proj", (H, D), ("uniform", 1.0 / math.sqrt(H))),
            ("rel_emb", (R, D), ("uniform", math.sqrt(6.0 / (R + D))))]
    return out


def layer_leaves(weights: dict) -> dict:
    """The leaves as the optimizer holds them: each stacked layer leaf split
    into one leaf a layer (`name@i`)."""
    out = {}
    for k, v in weights.items():
        if k.startswith("bert/layers/"):
            for i in range(v.shape[0]):
                out[f"{k}@{i}"] = v[i]
        else:
            out[k] = v
    return out


# -- operation counts ------------------------------------------------------------


def encoder_weights(cfg: dict) -> int:
    """Weights a token meets in the encoder's products."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (4 * H * H + 2 * H * I)


def forward_flops(cfg: dict, lengths) -> float:
    """Forward FLOPs of encoding descriptions of the given real lengths:
    2 per weight a real token meets, q k^T and p v over each sequence's own
    real keys (4 L^2 H a layer), and the projection of [CLS]."""
    H, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_tok = float(sum(int(x) for x in lengths))
    sq = float(sum(int(x) ** 2 for x in lengths))
    return (2.0 * encoder_weights(cfg) * n_tok + 4.0 * H * layers * sq
            + 2.0 * H * cfg["blp"]["dim"] * len(lengths))


def train_flops(cfg: dict, lengths) -> float:
    """A train step's model FLOPs: forward and backward (3 x forward), no
    recomputation."""
    return 3.0 * forward_flops(cfg, lengths)


# -- dropout masks ---------------------------------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_LO = 0xFFFFFFFF
#: Masks one Philox call gives, by the mask's width in bits.
PER_CALL = {32: 4, 16: 8, 8: 16}


def _mulhilo(m: int, b: torch.Tensor):
    """High and low words of m * b (m a 32-bit constant, b int64 holding 32
    bits): b in 16-bit halves, so no product leaves int64."""
    lo16 = m * (b & 0xFFFF)
    mid = m * (b >> 16) + (lo16 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox(q: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of the counters (q lo, q hi, 0, 0) under the key
    (seed lo, seed hi): (len(q), 4) int64 words (Salmon et al., SC 2011)."""
    k0, k1 = seed & _LO, (seed >> 32) & _LO
    c0, c1 = q & _LO, q >> 32
    c2 = torch.zeros_like(q)
    c3 = torch.zeros_like(q)
    for i in range(10):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & _LO, (k1 + PHILOX_W[1]) & _LO
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def keep_rule(rate: float, bits: int) -> tuple[int, float]:
    """(cut, keep probability): at 32 bits keep iff (word >> 8) <
    ceil(f32(1 - rate) * 2^24); at 8 or 16 keep iff the field >= t, t =
    min(round(rate * 2^bits), 2^bits - 1), keep probability 1 - t / 2^bits."""
    if bits == 32:
        keep = 1.0 - rate
        keep32 = struct.unpack("f", struct.pack("f", keep))[0]
        return math.ceil(keep32 * (1 << 24)), keep
    t = min(int(round(rate * (1 << bits))), (1 << bits) - 1)
    return t, 1.0 - t / (1 << bits)


def site_keep(seed: int, shape, rate: float, bits: int, device,
              calls_a_block: int = 1 << 24) -> torch.Tensor:
    """The keep bits (bool, `shape`) of a whole dropout site: element n
    (flat, row-major) is field n % m of Philox call n // m, m masks a call,
    a call's four words in order, each word's fields from its low bits."""
    numel = math.prod(shape)
    m = PER_CALL[bits]
    cut, _ = keep_rule(rate, bits)
    calls = -(-numel // m)
    out = torch.empty(calls * m, dtype=torch.bool, device=device)
    for c0 in range(0, calls, calls_a_block):
        c1 = min(c0 + calls_a_block, calls)
        words = philox(torch.arange(c0, c1, dtype=torch.int64, device=device), seed)
        if bits == 32:
            keep = (words >> 8) < cut
        else:
            per = 32 // bits
            shifts = torch.arange(per, device=device, dtype=torch.int64) * bits
            fields = (words[..., None] >> shifts) & ((1 << bits) - 1)
            keep = fields >= cut
        out[c0 * m:c1 * m] = keep.reshape(-1)
    return out[:numel].reshape(shape)


def pack_of(n: int, length: int) -> int:
    return next((p for p in (4, 2) if n % p == 0 and p * length <= 128), 1)


def step_masks(cfg: dict, n: int, length: int, dropout_seed: int,
               device) -> dict:
    """Every dropout site's keep bits of a training pass over n sequences
    of `length`, in the packed layout: "emb" (rows, P, H) and, per layer i,
    ("attn", i) (rows, heads, P, P), ("out", i) and ("ffn", i) (rows, P, H)."""
    tr = cfg["training"]
    bits = tr["dropout_bits"]
    hid, att = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    p = pack_of(n, length)
    rows, P = n // p, p * length
    masks = {"emb": site_keep(common.fold_seed(dropout_seed, 0), (rows, P, H),
                              hid, bits, device)}
    layer_seed = common.fold_seed(dropout_seed, 1)
    for i in range(cfg["num_hidden_layers"]):
        s = [common.fold_seed(layer_seed, 3 * i + j) for j in range(3)]
        masks["attn", i] = site_keep(s[0], (rows, nh, P, P), att, bits, device)
        masks["out", i] = site_keep(s[1], (rows, P, H), hid, bits, device)
        masks["ffn", i] = site_keep(s[2], (rows, P, H), hid, bits, device)
    return masks


# -- the reference ---------------------------------------------------------------


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _drop(x, keep, keep_p):
    return torch.where(keep, x / keep_p, torch.zeros_like(x))


def _layer(cfg, mode, x, bias, w, keeps):
    """One post-LN layer on packed rows x (rows, P, H); keeps: the layer's
    (attn, out, ffn) keep bits or None."""
    rows, P, H = x.shape
    nh = cfg["num_attention_heads"]
    hd = H // nh
    eps = cfg["layer_norm_eps"]
    keep_p = {k: keep_rule(r, cfg["training"]["dropout_bits"])[1] for k, r in
              (("h", cfg["hidden_dropout_prob"]),
               ("a", cfg["attention_probs_dropout_prob"]))}

    def heads(t):
        return t.reshape(rows, P, nh, hd).permute(0, 2, 1, 3)

    q = heads(common.mm(x, w["q_w"], mode) + w["q_b"])
    k = heads(common.mm(x, w["k_w"], mode) + w["k_b"])
    v = heads(common.mm(x, w["v_w"], mode) + w["v_b"])
    probs = torch.softmax(common.mm(q, k.transpose(-1, -2), mode) / math.sqrt(hd)
                          + bias, dim=-1)
    if keeps is not None:
        probs = _drop(probs, keeps[0], keep_p["a"])
    ctx = common.mm(probs, v, mode).permute(0, 2, 1, 3).reshape(rows, P, H)
    a = common.mm(ctx, w["attn_out_w"], mode) + w["attn_out_b"]
    if keeps is not None:
        a = _drop(a, keeps[1], keep_p["h"])
    x = _ln(x + a, w["attn_ln_scale"], w["attn_ln_bias"], eps)
    f = F.gelu(common.mm(x, w["ffn_in_w"], mode) + w["ffn_in_b"])
    f = common.mm(f, w["ffn_out_w"], mode) + w["ffn_out_b"]
    if keeps is not None:
        f = _drop(f, keeps[2], keep_p["h"])
    return _ln(x + f, w["ffn_ln_scale"], w["ffn_ln_bias"], eps)


def encode(cfg: dict, weights: dict, tok: torch.Tensor, mask: torch.Tensor, *,
           mode: str = "fp32", masks: dict | None = None,
           remat: bool = False) -> torch.Tensor:
    """(n, dim) entity rows before normalization: tok, mask (n, L). With
    `masks` (`step_masks`) the pass drops as training does; `remat`
    recomputes each layer in the backward so that a whole batch fits."""
    n, L = tok.shape
    H = cfg["hidden_size"]
    eps = cfg["layer_norm_eps"]
    g = lambda k: weights[f"bert/embeddings/{k}"]  # noqa: E731
    x = g("word")[tok.long()] + g("position")[:L][None] + g("token_type")[0]
    x = _ln(x, g("ln_scale"), g("ln_bias"), eps)
    p = pack_of(n, L)
    rows, P = n // p, p * L
    x = x.reshape(rows, P, H)
    key = mask.to(torch.float32).reshape(rows, P)
    block = torch.arange(P, device=x.device) // L
    visible = (block[:, None] == block[None, :])[None] & (key[:, None, :] > 0)
    bias = torch.where(visible, 0.0, -10000.0)[:, None]
    if masks is not None:
        x = _drop(x, masks["emb"], keep_rule(cfg["hidden_dropout_prob"],
                                             cfg["training"]["dropout_bits"])[1])
    for i in range(cfg["num_hidden_layers"]):
        w = {k.rsplit("/", 1)[1]: v[i] for k, v in weights.items()
             if k.startswith("bert/layers/")}
        keeps = None if masks is None else (masks["attn", i], masks["out", i],
                                            masks["ffn", i])
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, cfg, mode, x, bias, w, keeps,
                           use_reentrant=False)
        else:
            x = _layer(cfg, mode, x, bias, w, keeps)
    cls = x.reshape(n, L, H)[:, 0]
    return common.mm(cls, weights["proj"], mode)


def train_encode(cfg: dict, weights: dict, tok, mask, dropout_seed: int, *,
                 mode: str = "fp32") -> torch.Tensor:
    """The training pass's rows (n, dim), dropout from `dropout_seed`."""
    masks = step_masks(cfg, tok.shape[0], tok.shape[1], dropout_seed, tok.device)
    return encode(cfg, weights, tok, mask, mode=mode, masks=masks, remat=True)
