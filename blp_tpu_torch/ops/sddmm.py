"""K3: fused positive + in-batch negative scoring for the training loss.

Port of blp_tpu/ops/pallas_sddmm.py. Training scores only the observed edge
and its K sampled corruptions, an SDDMM-shaped computation: the plain
formulation gathers (B, K, d) head and tail tensors from the (2B, d)
in-batch entity matrix and scores them; the CUDA kernel (csrc/sddmm.cu)
gathers the rows itself, from L2, and writes the (B, 1) positive and (B, K)
negative scores directly.

Gradients: `_SddmmScores` is a `torch.autograd.Function` whose forward runs
the kernel on a CUDA tensor (the plain version on a CPU one) and whose
backward is the VJP of the plain formulation on the saved inputs, as the TPU
package's custom_vjp does. A hand-written backward kernel is later work.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between them. Any B runs: the TPU
kernel's B % block_b condition was an artifact of its tiling.
"""

from __future__ import annotations

import ctypes

import torch

from blp_tpu_torch.models import scoring
from blp_tpu_torch.ops import _cuda

#: Scorer ids of the C entry point.
MODELS = {"transe": 0, "distmult": 1, "complex": 2, "simple": 3}

#: Kernel launches since the last reset (a plain counter; chip_smoke.py reads
#: it to show the main path went through the kernel).
launches = 0


def sddmm_scores_plain(ent_flat, rel_emb, neg_idx, rel_model: str):
    """The `_sddmm_xla` formulation: gather, then score. Returns
    (pos (B, 1), neg (B, K)).

    The positive pair (rows 2b, 2b + 1) is gathered with the negatives in
    one index, so the gradient reaches ent_flat through one index backward
    and rel_emb through one broadcast: its sums do not depend on the order
    in which autograd visits branches, and the Function's backward below
    gives the same bits as autograd through this function wherever the
    index backward is deterministic (CUDA's sort-based one is; on the CPU
    its accumulation order varies with the thread count)."""
    B = rel_emb.shape[0]
    score = scoring.get_score_fn(rel_model)
    own = torch.arange(2 * B, device=ent_flat.device).reshape(B, 1, 2)
    idx = torch.cat([own, neg_idx.long()], dim=1)              # (B, 1 + K, 2)
    rows = ent_flat[idx]                                       # (B, 1 + K, 2, d)
    scores = score(rows[..., 0, :], rows[..., 1, :], rel_emb[:, None, :])
    return scores[:, :1], scores[:, 1:]


def _sddmm_kernel(ent_flat, rel_emb, neg_idx, rel_model: str):
    global launches
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
    units = d // 2 if rel_model in ("complex", "simple") else d
    lib = _cuda.load("sddmm")
    if units > lib.sddmm_max_units(4):
        raise ValueError(f"sddmm: width {d} exceeds the kernel's register "
                         f"layout ({lib.sddmm_max_units(4)} units)")
    K = neg_idx.shape[1]
    dev = ent_flat.device
    ent = ent_flat.contiguous()
    rel = rel_emb.to(dev).contiguous()
    idx = neg_idx.to(dev, torch.int32).contiguous()
    pos = torch.empty((B, 1), dtype=torch.float32, device=dev)
    neg = torch.empty((B, K), dtype=torch.float32, device=dev)
    fn = lib.sddmm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 3
    err = fn(ent.data_ptr(), rel.data_ptr(), idx.data_ptr(), B, K, d,
             MODELS[rel_model], pos.data_ptr(), neg.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "sddmm launch")
    launches += 1
    return pos, neg


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
        with torch.enable_grad():
            e = ent_flat.detach().requires_grad_()
            r = rel_emb.detach().requires_grad_()
            pos, neg = sddmm_scores_plain(e, r, neg_idx, ctx.rel_model)
            d_ent, d_rel = torch.autograd.grad((pos, neg), (e, r),
                                               (g_pos, g_neg))
        return d_ent, d_rel, None, None


def sddmm_scores(ent_flat, rel_emb, neg_idx, rel_model: str = "transe"):
    """Fused positive + negative scoring.

    ent_flat: (2B, d) in-batch entity embeddings ([h0, t0, h1, t1, ...]);
    rel_emb: (B, d); neg_idx: (B, K, 2) indices into ent_flat's rows.
    Returns (pos_scores (B, 1), neg_scores (B, K)), differentiable in
    ent_flat and rel_emb.
    """
    return _SddmmScores.apply(ent_flat, rel_emb, neg_idx, rel_model)
