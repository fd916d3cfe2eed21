"""K3: fused positive + in-batch negative scoring for the training loss.

Port of blp_tpu/ops/pallas_sddmm.py. Training scores only the observed edge
and its K sampled corruptions, an SDDMM-shaped computation: the plain
formulation gathers (B, K, d) head and tail tensors from the (2B, d)
in-batch entity matrix and scores them; the CUDA kernel (csrc/sddmm.cu)
gathers the rows itself, from L2, reusing each edge's own rows from
registers, and writes the (B, 1) positive and (B, K) negative scores
directly.

Gradients: `_SddmmScores` is a `torch.autograd.Function`. Its backward does
not re-enter autograd. On a CUDA tensor it sorts the tasks' slot ids
(`_backward_order`, index bookkeeping in torch ops, no host sync) and
launches one hand-written kernel that forms every partial derivative and
adds each entity row's contributions in that stable sorted order and each
relation row's over j = 0..K, one warp per row, with no atomics: the same
bits on every call. On a CPU tensor it runs `sddmm_scores_backward_plain`,
the same formulas added in the same order (so the two agree bit for bit;
both are within fp32 rounding of autograd through `sddmm_scores_plain` and
of `jax.vjp` of the TPU package's `_sddmm_xla`, which add in other orders).

Routing: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises. There is no fallback between them. Any B runs: the TPU
kernel's B % block_b condition was an artifact of its tiling.
"""

from __future__ import annotations

import ctypes

import torch

from blp_tpu_torch.models import scoring
from blp_tpu_torch.ops import _cuda

#: Scorer ids of the C entry points.
MODELS = {"transe": 0, "distmult": 1, "complex": 2, "simple": 3}

#: Kernel launches since the last reset, forward and backward (plain
#: counters; chip_smoke.py reads them to show the main path went through
#: the kernels).
launches = 0
backward_launches = 0


def sddmm_scores_plain(ent_flat, rel_emb, neg_idx, rel_model: str):
    """The `_sddmm_xla` formulation: gather, then score. Returns
    (pos (B, 1), neg (B, K)).

    The positive pair (rows 2b, 2b + 1) is gathered with the negatives in
    one index, so autograd through it reaches ent_flat through one index
    backward and rel_emb through one broadcast."""
    B = rel_emb.shape[0]
    score = scoring.get_score_fn(rel_model)
    own = torch.arange(2 * B, device=ent_flat.device).reshape(B, 1, 2)
    idx = torch.cat([own, neg_idx.long()], dim=1)              # (B, 1 + K, 2)
    rows = ent_flat[idx]                                       # (B, 1 + K, 2, d)
    scores = score(rows[..., 0, :], rows[..., 1, :], rel_emb[:, None, :])
    return scores[:, :1], scores[:, 1:]


def _backward_order(neg_idx, B: int):
    """Index bookkeeping of the backward, on neg_idx's device, no host sync.

    Returns slots (B, 1 + K, 2) int32, the tasks' slot ids in (b, j, side)
    order with the own pair (2b, 2b + 1) as j = 0; sorted_slots and order,
    the stable sort of their flattening (order int64); and starts (2B + 1,)
    int64, where entity row e's run of contributions begins in it."""
    dev = neg_idx.device
    own = torch.arange(2 * B, dtype=torch.int32, device=dev).reshape(B, 1, 2)
    slots = torch.cat([own, neg_idx.to(torch.int32)], dim=1)
    sorted_slots, order = torch.sort(slots.reshape(-1), stable=True)
    starts = torch.searchsorted(
        sorted_slots, torch.arange(2 * B + 1, dtype=torch.int32, device=dev))
    return slots, sorted_slots, order, starts


def _score_partials(h, t, r, g, rel_model: str):
    """The partial derivatives of models/scoring.py's scores with respect to
    the head, tail and relation rows, times the cotangent g (broadcast on
    the last axis). Each product and sum is rounded on its own, in the
    order csrc/sddmm.cu's `partials` forms them."""
    if rel_model == "transe":
        # d|x|/dx is sign(x), with sign(0) = 0 as in torch's and jax's abs.
        u = (-g) * torch.sign((h + r) - t)
        return u, -u, u
    if rel_model == "distmult":
        return (r * t) * g, (h * r) * g, (h * t) * g
    (ha, hb), (ta, tb), (ra, rb) = (torch.chunk(x, 2, dim=-1) for x in (h, t, r))
    if rel_model == "complex":      # a = re, b = im
        dh = ((ra * ta + rb * tb) * g, (ra * tb - rb * ta) * g)
        dt = ((ra * ha - rb * hb) * g, (ra * hb + rb * ha) * g)
        dr = ((ha * ta + hb * tb) * g, (ha * tb - hb * ta) * g)
    else:                           # simple: a = first half, b = second half
        g2 = g * 0.5
        dh = ((ra * tb) * g2, (ta * rb) * g2)
        dt = ((rb * hb) * g2, (ha * ra) * g2)
        dr = ((ha * tb) * g2, (ta * hb) * g2)
    return tuple(torch.cat(p, dim=-1) for p in (dh, dt, dr))


def sddmm_scores_backward_plain(ent_flat, rel_emb, neg_idx, g_pos, g_neg,
                                rel_model: str):
    """The gradients (d_ent (2B, d), d_rel (B, d)) of sddmm_scores_plain's
    outputs against the cotangents g_pos (B, 1) and g_neg (B, K), without
    autograd: the explicit partials of every task, added into each entity
    row in the stable sorted order of `_backward_order` and into each
    relation row over j = 0..K (index_add_ adds in index order on the CPU,
    as the kernel does)."""
    scoring.get_score_fn(rel_model)       # raises the package's error
    B, d = rel_emb.shape
    slots, sorted_slots, order, _ = _backward_order(neg_idx, B)
    idx = slots.long()
    h, t = ent_flat[idx[..., 0]], ent_flat[idx[..., 1]]       # (B, 1 + K, d)
    r = rel_emb[:, None, :].expand_as(h)
    g = torch.cat([g_pos.reshape(B, 1), g_neg], dim=1)[..., None]
    dh, dt, dr = _score_partials(h, t, r, g, rel_model)
    contrib = torch.stack([dh, dt], dim=2).reshape(-1, d)     # (b, j, side)
    d_ent = torch.zeros_like(ent_flat).index_add_(
        0, sorted_slots.long(), contrib[order])
    rows = torch.arange(B, device=rel_emb.device).repeat_interleave(idx.shape[1])
    d_rel = torch.zeros_like(rel_emb).index_add_(0, rows, dr.reshape(-1, d))
    return d_ent, d_rel


#: Chunks per lane of the kernels' register layout (csrc/sddmm.cu kMaxChunks).
MAX_CHUNKS = 8


def vector_width(units: int, d: int, ent_ptr: int, rel_ptr: int) -> int:
    """The vector width csrc/sddmm.cu's `vector_width` picks for rows of
    `units` units (elements for transe/distmult, pairs for complex/simple)
    of width d at the addresses ent_ptr and rel_ptr: 4 where the unit count
    and d are multiples of 4 and both are 16-byte aligned, else 2 where they
    are even and 8-byte aligned, else 1."""
    if units % 4 == 0 and d % 4 == 0 and ent_ptr % 16 == 0 and rel_ptr % 16 == 0:
        return 4
    if units % 2 == 0 and d % 2 == 0 and ent_ptr % 8 == 0 and rel_ptr % 8 == 0:
        return 2
    return 1


def max_units(v: int) -> int:
    """The largest unit count the register layout takes at vector width v
    (csrc/sddmm.cu `sddmm_max_units`)."""
    return 32 * v * MAX_CHUNKS


_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes signatures of the C entry points, bound once at first use.
_SIGNATURES = {
    "sddmm_launch": [_P] * 3 + [_I] * 4 + [_P] * 3,
    "sddmm_backward_launch": [_P] * 7 + [_I] * 4 + [_P] * 3,
}
_entry: dict = {}


def _bound(name: str):
    """The C entry point `name` of csrc/sddmm.cu with its signature set."""
    fn = _entry.get(name)
    if fn is None:
        lib = _cuda.load("sddmm")
        for sym, argtypes in _SIGNATURES.items():
            f = getattr(lib, sym)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            _entry[sym] = f
        fn = _entry[name]
    return fn


def _checked(ent_flat, rel_emb, neg_idx, rel_model: str):
    """Shape, type and width checks of the kernels; returns the inputs as
    the kernels take them (contiguous, on ent_flat's device, int32 indices),
    copying only what does not qualify."""
    if rel_model not in MODELS:
        scoring.get_score_fn(rel_model)   # raises the package's error
    B, d = rel_emb.shape
    if neg_idx.dim() != 3 or neg_idx.shape[0] != B or neg_idx.shape[2] != 2:
        raise ValueError(f"sddmm: neg_idx {tuple(neg_idx.shape)} is not "
                         f"(B={B}, K, 2)")
    if tuple(ent_flat.shape) != (2 * B, d):
        raise ValueError(f"sddmm: ent_flat {tuple(ent_flat.shape)} is not "
                         f"(2B, d) = ({2 * B}, {d})")
    if ent_flat.dtype != torch.float32 or rel_emb.dtype != torch.float32:
        raise TypeError("sddmm: embeddings must be float32")
    if rel_model in ("complex", "simple") and d % 2:
        raise ValueError(f"sddmm: {rel_model} needs an even width, got {d}")
    dev = ent_flat.device
    if not ent_flat.is_contiguous():
        ent_flat = ent_flat.contiguous()
    if rel_emb.device != dev or not rel_emb.is_contiguous():
        rel_emb = rel_emb.to(dev).contiguous()
    units = d // 2 if rel_model in ("complex", "simple") else d
    v = vector_width(units, d, ent_flat.data_ptr(), rel_emb.data_ptr())
    if units > max_units(v):
        raise ValueError(
            f"sddmm: width {d} ({units} units) exceeds the kernel's register "
            f"layout at vector width {v}: at most {max_units(v)} units "
            f"(32 lanes x {v} x {MAX_CHUNKS} chunks)")
    if (neg_idx.dtype != torch.int32 or neg_idx.device != dev
            or not neg_idx.is_contiguous()):
        neg_idx = neg_idx.to(dev, torch.int32).contiguous()
    return ent_flat, rel_emb, neg_idx


def _sddmm_kernel(ent_flat, rel_emb, neg_idx, rel_model: str):
    global launches
    ent, rel, idx = _checked(ent_flat, rel_emb, neg_idx, rel_model)
    (B, d), K = rel.shape, idx.shape[1]
    pos = torch.empty((B, 1), dtype=torch.float32, device=ent.device)
    neg = torch.empty((B, K), dtype=torch.float32, device=ent.device)
    err = _bound("sddmm_launch")(
        ent.data_ptr(), rel.data_ptr(), idx.data_ptr(), B, K, d,
        MODELS[rel_model], pos.data_ptr(), neg.data_ptr(),
        torch.cuda.current_stream(ent.device).cuda_stream)
    _cuda.check(err, "sddmm launch")
    launches += 1
    return pos, neg


def _sddmm_backward_kernel(ent_flat, rel_emb, neg_idx, g_pos, g_neg,
                           rel_model: str):
    global backward_launches
    ent, rel, idx = _checked(ent_flat, rel_emb, neg_idx, rel_model)
    (B, d), K = rel.shape, idx.shape[1]
    slots, _, order, starts = _backward_order(idx, B)
    g_pos = g_pos.to(ent.device, torch.float32).contiguous()
    g_neg = g_neg.to(ent.device, torch.float32).contiguous()
    d_ent = torch.empty_like(ent)
    d_rel = torch.empty_like(rel)
    err = _bound("sddmm_backward_launch")(
        ent.data_ptr(), rel.data_ptr(), slots.data_ptr(), order.data_ptr(),
        starts.data_ptr(), g_pos.data_ptr(), g_neg.data_ptr(), B, K, d,
        MODELS[rel_model], d_ent.data_ptr(), d_rel.data_ptr(),
        torch.cuda.current_stream(ent.device).cuda_stream)
    _cuda.check(err, "sddmm backward launch")
    backward_launches += 1
    return d_ent, d_rel


class _SddmmScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ent_flat, rel_emb, neg_idx, rel_model):
        ctx.save_for_backward(ent_flat, rel_emb, neg_idx)
        ctx.rel_model = rel_model
        if ent_flat.is_cuda:
            return _sddmm_kernel(ent_flat, rel_emb, neg_idx, rel_model)
        return sddmm_scores_plain(ent_flat, rel_emb, neg_idx, rel_model)

    @staticmethod
    def backward(ctx, g_pos, g_neg):
        ent_flat, rel_emb, neg_idx = ctx.saved_tensors
        backward = (_sddmm_backward_kernel if ent_flat.is_cuda
                    else sddmm_scores_backward_plain)
        d_ent, d_rel = backward(ent_flat, rel_emb, neg_idx, g_pos, g_neg,
                                ctx.rel_model)
        return d_ent, d_rel, None, None


def sddmm_scores(ent_flat, rel_emb, neg_idx, rel_model: str = "transe"):
    """Fused positive + negative scoring.

    ent_flat: (2B, d) in-batch entity embeddings ([h0, t0, h1, t1, ...]);
    rel_emb: (B, d); neg_idx: (B, K, 2) indices into ent_flat's rows.
    Returns (pos_scores (B, 1), neg_scores (B, K)), differentiable in
    ent_flat and rel_emb.
    """
    return _SddmmScores.apply(ent_flat, rel_emb, neg_idx, rel_model)
