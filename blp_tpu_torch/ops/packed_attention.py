"""K2: packed block-diagonal attention for the bf16 inference encoder.

Port of blp_tpu/ops/pallas_attention.py. The fast inference encoder packs
`Sp / seg` descriptions into one row; a query attends only to the real keys
of its own segment. The CUDA kernel (csrc/packed_attention.cu) computes, per
(row, head), q k^T with f32 accumulation, `* scale + bias` in f32 with the
bias rebuilt from the (Sp,) key mask, one round to bf16, a softmax with f32
statistics, p to bf16, and p v with f32 accumulation, written as bf16 into
the (B, Sp, nh*hd) layout the attention-output GEMM reads. It computes only
each segment's diagonal block (exact: keys outside a query's segment get
probability exactly 0 when its segment has a real key) and runs a segment
with no real key against the whole row, as the TPU kernel does.

Routing: `block_diag_attention` runs the plain version for tensors on the
CPU and the kernel for CUDA tensors, with no fallback between them (the TPU
package's interpret fallback is gone).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from blp_tpu_torch.ops import _cuda

#: Kernel launches since the last reset (a plain counter), and the same
#: launches by segment length.
launches = 0
launches_by_seg: collections.Counter = collections.Counter()

#: Shared memory one block may use on Hopper (227 KB).
_SMEM_LIMIT = 232_448


def block_bias(key_mask: torch.Tensor, seg: int) -> torch.Tensor:
    """(B, 1, Sp, Sp) f32 additive bias: 0 for a real key of the query's own
    segment, -10000 otherwise."""
    sp = key_mask.shape[-1]
    idx = torch.arange(sp, device=key_mask.device) // seg
    visible = (idx[:, None] == idx[None, :])[None] & (key_mask[:, None, :] > 0)
    return torch.where(visible, 0.0, -10000.0).to(torch.float32)[:, None]


def block_diag_attention_plain(q, k, v, key_mask, *, seg: int,
                               scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the formula of the TPU
    package's einsum reference): products of bf16 values in f32, the bias and
    the bf16 round of the logits, f32 softmax, bf16 probabilities."""
    b, nh, sp, hd = q.shape
    bias = block_bias(key_mask.to(torch.float32), seg)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = (logits * scale + bias).to(torch.bfloat16)
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    ctx = torch.matmul(p.float(), v.float())                 # (B, nh, Sp, hd)
    return ctx.permute(0, 2, 1, 3).reshape(b, sp, nh * hd).to(torch.bfloat16)


def _kernel(q, k, v, key_mask, *, seg: int, scale: float) -> torch.Tensor:
    global launches
    b, nh, sp, hd = q.shape
    if not all(t.is_cuda and t.device == q.device for t in (k, v, key_mask)):
        raise ValueError("packed_attention: all inputs must be on one CUDA device")
    if k.shape != q.shape or v.shape != q.shape or key_mask.shape != (b, sp):
        raise ValueError(f"packed_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, key_mask "
                         f"{tuple(key_mask.shape)} do not match")
    q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    mask = key_mask.to(torch.float32).contiguous()
    if hd % 8 == 0 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("packed_attention: q, k, v must be 16-byte aligned")
    if hd > 128:
        raise ValueError(f"packed_attention: head dim {hd} above 128")
    lib = _cuda.load("packed_attention")
    smem = lib.packed_attention_smem_bytes
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    if smem(sp, hd) > _SMEM_LIMIT:
        raise ValueError(f"packed_attention: Sp={sp}, hd={hd} needs "
                         f"{smem(sp, hd)} bytes of shared memory per block, "
                         f"above the {_SMEM_LIMIT} a Hopper block may use")
    out = torch.empty((b, sp, nh * hd), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:   # an empty grid is not a valid launch
        return out
    fn = lib.packed_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             out.data_ptr(), b, nh, sp, hd, seg, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "packed_attention launch")
    launches += 1
    launches_by_seg[seg] += 1
    return out


def block_diag_attention(q, k, v, key_mask, *, seg: int,
                         scale: float) -> torch.Tensor:
    """Fused packed attention.

    q, k, v: (B, nh, Sp, hd) bf16 head-major projections; key_mask: (B, Sp),
    1 for real tokens; seg: segment length (Sp must divide by it). Returns
    (B, Sp, nh*hd) bf16. The kernel on CUDA tensors, the plain version on
    CPU tensors. The kernel stages a (row, head) pair's q, k and v in shared
    memory, so it raises for rows too long for that (Sp > 592 at hd 64) and
    for hd above 128; packed BERT rows are at most 128 tokens, BERT's
    positions 512.
    """
    sp = q.shape[2]
    if sp % seg:
        raise ValueError(f"Sp={sp} not divisible by segment length {seg}")
    if q.is_cuda:
        return _kernel(q, k, v, key_mask, seg=seg, scale=scale)
    return block_diag_attention_plain(q, k, v, key_mask, seg=seg, scale=scale)
