"""F3: the BERT layer's attention softmax chain as one CUDA kernel.

The JAX package has no Pallas kernel here: XLA fuses the chain of
blp_tpu/models/bert.py, the training layer's scale, mask bias,
`jax.nn.softmax`, bf16 cast and `_rng_dropout` (:430-441) and the inference
layer's bf16 logits with f32 softmax statistics (:357-365). Run op by op in
PyTorch the chain writes and re-reads an f32 tensor of the (B, heads, S, S)
logits' shape at each step, and autograd saves the f32 softmax output (6 KB
a token at S 128 and 12 heads).

`attn_softmax(l, mask_bias, scale, out_dtype, round_logits, dropout)`:
y = drop(round_out(softmax(f32(l) / scale + mask_bias))). l is the QK^T
product (B, heads, Sq, Sk) in bf16 or f32, mask_bias the additive f32 bias
broadcastable to it, scale the divisor sqrt(head_dim), out_dtype the dtype
of y. `round_logits` (the inference layer) rounds the scaled, biased logits
to bf16 first (-10000 becomes -9984) and takes the max over those values,
then exp(f32 - max) / sum. `dropout` is a dropout site's (seed, rate, nbits,
block): drop(y) = where(keep, y / keep_p, 0) in out_dtype, with `keep` the
site's mask of ops/dropout_rng.py (`block`: None, or the (whole shape,
start) of this call's rows and heads in the site), so the masks are the ones
`_rng_dropout` applies. The backward saves only l (3 KB a token in bf16),
recomputes the row's f32 softmax from it, the same `keep` from the seed,
and returns dl in l's dtype, rounding where the op-by-op chain's backward
rounds.

The CUDA kernels (csrc/attn_softmax.cu) sum within a row, without atomics,
so two calls give the same bits, and evaluate the keep bits in registers
(csrc/dropout_rng.cuh): no mask is drawn or stored. `design` picks one of
two by shape, strides and alignment: "tile" (Sk % 8 == 0, Sk <= 256, a bias
with no head stride: every call of the layer), a persistent grid that
copies each tile of query rows for all heads into a ring in shared memory
and reads its bias once for all heads, with `tile_plan`'s ring; "row" (the
rest, Sk <= MAX_SK), a warp a row in registers. `attn_softmax_plain` is
the arithmetic of the unfused layer. On CPU tensors the forward runs it,
and the backward recomputes it from l and differentiates it with
torch.autograd, so CPU results equal the unfused chain's bit for bit while
saving only l; CUDA tensors launch a kernel or raise. The wrapper allocates
with torch ops and launches on the current stream, so the selective
checkpoint policies (models/bert.py) recompute it.
"""

from __future__ import annotations

import ctypes

import torch

from blp_tpu_torch.ops import _cuda, dropout_rng, fused_layer

#: The longest row (keys) the kernels take (the row design holds it in a
#: warp's registers).
MAX_SK = 1024
#: The tile design: rows of at most TILE_MAX_SK keys, a multiple of 8; a lane
#: holds TILE_LANE_KEYS keys of a row (two chunks of 8); TILE_WARPS consumer
#: warps, each a step of 32 lanes a slab; as many ring stages (at least 2,
#: at most TILE_MAX_STAGES) as fit TILE_BLOCK_SMEM beside the two bias slots
#: and the barriers, so that three blocks fit an SM's 228 KB.
TILE_MAX_SK = 256
TILE_LANE_KEYS = 16
TILE_WARPS = 8
TILE_BLOCK_SMEM = 72 * 1024
TILE_MAX_STAGES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: (l dtype, out dtype) pairs the kernel takes: the ones the layer uses.
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32)}

#: Kernel launches since the last reset (plain counters; chip_smoke.py reads
#: them). Launches by variant go to fused_layer.launches_by_variant under
#: ("attn_softmax", "<tile|row> <l dtype>-><out dtype>
#: <round|drop<nbits>|plain> sk<Sk>") and ("attn_softmax backward", ...).
launches = 0
backward_launches = 0


def _check_sk(l) -> None:
    if l.dim() != 4:
        raise ValueError(f"attn_softmax: logits {tuple(l.shape)} are not "
                         "(batch, heads, queries, keys)")
    if l.shape[-1] > MAX_SK:
        raise ValueError(f"attn_softmax: {l.shape[-1]} keys is above {MAX_SK} "
                         "(the kernel holds a row in one warp's registers)")


def _softmax_plain(l, mask_bias, scale: float, out_dtype, round_logits: bool):
    """The chain before the dropout, op by op as the unfused layer runs it."""
    x = l.to(torch.float32) / scale + mask_bias
    if round_logits:
        x = x.to(torch.bfloat16)
        m = x.amax(dim=-1, keepdim=True).to(torch.float32)
        e = torch.exp(x.to(torch.float32) - m)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(x, dim=-1)
    return p.to(out_dtype)


def attn_softmax_plain(l, mask_bias, scale: float, out_dtype,
                       round_logits: bool = False, dropout=None):
    """F3's function in plain PyTorch (see the module doc)."""
    p = _softmax_plain(l, mask_bias, scale, out_dtype, round_logits)
    return p if dropout is None else fused_layer.site_dropout_plain(p, dropout)


# -- the kernel ----------------------------------------------------------------

_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)
#: The dropout site's arguments: seed words, nbits, threshold, keep_p, first
#: row, first head, the site's heads.
_DROP = [_U, _U, _I, _U, _F, _L, _I, _I]
_SIGNATURES = {
    "attn_softmax_forward": [_P, _P] + [_L] * 4 + [_P, _L] + [_I] * 5 + [_F, _I]
                            + _DROP + [_I, _P],
    "attn_softmax_backward": [_P, _P] + [_L] * 4 + [_P, _P, _L] + [_I] * 5 + [_F]
                             + _DROP + [_I, _P],
}
_entry: dict = {}


def _bound(name: str):
    fn = _entry.get(name)
    if fn is None:
        lib = _cuda.load("attn_softmax")
        for sym, argtypes in _SIGNATURES.items():
            f = getattr(lib, sym)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            _entry[sym] = f
        fn = _entry[name]
    return fn


def _operands(l, mask_bias, out_dtype):
    """l contiguous and the bias broadcast to l's shape (f32; the kernel
    reads it through its strides)."""
    if not l.is_cuda:
        raise ValueError("attn_softmax: logits are not on a CUDA device")
    if (l.dtype, out_dtype) not in _PAIRS:
        raise TypeError(f"attn_softmax: logits {l.dtype} with output {out_dtype} "
                        "is not one of bf16->bf16, bf16->f32, f32->f32")
    return l.contiguous(), mask_bias.to(l.device, torch.float32).expand(l.shape)


def _drop_args(dropout, shape) -> tuple:
    """The kernel's dropout arguments: the generator's, then the call's
    first row and head in the site and the site's heads."""
    block = (0, 0, shape[1]) if dropout is None else dropout_rng.head_block(
        shape, dropout[3])
    return (*dropout_rng.kernel_args(dropout), *block)


def _dims(l):
    b, nh, sq, sk = l.shape
    return b * nh * sq, nh, sq, sk


def tile_plan(sk: int, l_dtype, out_dtype, backward: bool) -> tuple[int, int, int]:
    """(lanes a row, rows a tile, ring stages) of the tile design for rows of
    sk keys (csrc/attn_softmax.cu `lanes_per_row`, `tile_rows`): a slab is
    a tile's rows of one head, l's (and g's in the backward); two bias slots
    hold a tile's rows of f32 bias, and 512 bytes cover the barriers."""
    lanes = 4 if sk <= 64 else 8 if sk <= 128 else 16
    rows = TILE_WARPS * 32 // lanes
    slab = rows * sk * (l_dtype.itemsize + (out_dtype.itemsize if backward else 0))
    room = TILE_BLOCK_SMEM - 512 - 2 * rows * sk * 4
    return lanes, rows, max(2, min(TILE_MAX_STAGES, room // slab))


def design(l, bias, out, g=None, round_logits=False, dropout=None) -> str:
    """"tile" where the tile design takes the call (csrc/attn_softmax.cu
    `tile_ok`: Sk % 8 == 0 and <= TILE_MAX_SK; rounded logits only without
    dropout; the bias, broadcast to l's shape, with key stride 1, no head
    stride unless there is one head, batch and query strides that are
    multiples of 4; every pointer 16-byte aligned), else "row"."""
    b, nh, sq, sk = l.shape
    sb, sh, sqs, sks = bias.stride()
    ptrs = (l, bias, out) if g is None else (l, bias, out, g)
    ok = (sk % 8 == 0 and sk <= TILE_MAX_SK and not (round_logits and dropout)
          and sks == 1 and (sh == 0 or nh == 1)
          and (b == 1 or sb % 4 == 0) and (sq == 1 or sqs % 4 == 0)
          and all(t.data_ptr() % 16 == 0 for t in ptrs))
    return "tile" if ok else "row"


def _variant(which, l, out_dtype, round_logits, dropout) -> str:
    kind = ("round" if round_logits else
            "plain" if dropout is None else f"drop{dropout[2]}")
    return (f"{which} {_NAMES[l.dtype]}->{_NAMES[out_dtype]} {kind} "
            f"sk{l.shape[-1]}")


def _stages(which, l, out_dtype, backward) -> int:
    """The C entry points' `stages`: 0 for the row design."""
    if which == "row":
        return 0
    return tile_plan(l.shape[-1], l.dtype, out_dtype, backward)[2]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _which(which, chosen: str) -> str:
    """`design`'s choice, or the row design where `which` asks for it (a
    yardstick: the row design takes every call)."""
    if which not in (None, "row"):
        raise ValueError(f"attn_softmax: design {which!r} is not None or 'row'")
    return which or chosen


def _forward_kernel(l, mask_bias, scale, out_dtype, round_logits, dropout,
                    which=None):
    global launches
    l, bias = _operands(l, mask_bias, out_dtype)
    drop = _drop_args(dropout, l.shape)
    y = torch.empty(l.shape, dtype=out_dtype, device=l.device)
    if l.numel() == 0:      # an empty grid is not a valid launch
        return y
    kind = _which(which, design(l, bias, y, round_logits=round_logits,
                                dropout=dropout))
    err = _bound("attn_softmax_forward")(
        l.data_ptr(), bias.data_ptr(), *bias.stride(), y.data_ptr(), *_dims(l),
        _DTYPES[l.dtype], _DTYPES[out_dtype], scale, int(round_logits), *drop,
        _stages(kind, l, out_dtype, False), _stream(l.device))
    _cuda.check(err, f"attn_softmax launch ({kind})")
    launches += 1
    fused_layer.launches_by_variant[
        "attn_softmax", _variant(kind, l, out_dtype, round_logits, dropout)] += 1
    return y


def _backward_kernel(g, l, mask_bias, scale, dropout, which=None):
    """dl from the cotangent g of y (the training variant)."""
    global backward_launches
    l, bias = _operands(l, mask_bias, g.dtype)
    drop = _drop_args(dropout, l.shape)
    g = g.contiguous()
    dl = torch.empty(l.shape, dtype=l.dtype, device=l.device)
    if l.numel() == 0:
        return dl
    kind = _which(which, design(l, bias, dl, g))
    err = _bound("attn_softmax_backward")(
        l.data_ptr(), bias.data_ptr(), *bias.stride(), g.data_ptr(), dl.data_ptr(),
        *_dims(l), _DTYPES[l.dtype], _DTYPES[g.dtype], scale, *drop,
        _stages(kind, l, g.dtype, True), _stream(l.device))
    _cuda.check(err, f"attn_softmax backward launch ({kind})")
    backward_launches += 1
    fused_layer.launches_by_variant[
        "attn_softmax backward", _variant(kind, l, g.dtype, False, dropout)] += 1
    return dl


# -- autograd ------------------------------------------------------------------

class _AttnSoftmax(torch.autograd.Function):
    """F3. Saves l alone; the bias (one tensor for every layer) is kept on
    the context."""

    @staticmethod
    def forward(ctx, l, mask_bias, scale, out_dtype, round_logits, dropout):
        ctx.mask_bias = mask_bias
        ctx.args = (scale, out_dtype, round_logits, dropout)
        ctx.save_for_backward(l)
        if l.is_cuda:
            return _forward_kernel(l, mask_bias, scale, out_dtype, round_logits,
                                   dropout)
        return attn_softmax_plain(l, mask_bias, scale, out_dtype, round_logits,
                                  dropout)

    @staticmethod
    def backward(ctx, g):
        l, = ctx.saved_tensors
        scale, out_dtype, round_logits, dropout = ctx.args
        if g.is_cuda:
            if round_logits:
                raise ValueError("attn_softmax: the kernel's backward takes "
                                 "the training variant (round_logits=False)")
            dl = _backward_kernel(g, l, ctx.mask_bias, scale, dropout)
            return dl, None, None, None, None, None
        # The unfused chain's backward: `_rng_dropout`'s, then autograd's
        # through the chain recomputed from l; the same ops, hence the same
        # bits.
        if dropout is not None:
            g = fused_layer.site_dropout_plain(g, dropout)
        with torch.enable_grad():
            ll = l.detach().requires_grad_()
            p = _softmax_plain(ll, ctx.mask_bias, scale, out_dtype, round_logits)
            dl, = torch.autograd.grad(p, ll, g)
        return dl, None, None, None, None, None


def attn_softmax(l, mask_bias, scale: float, out_dtype,
                 round_logits: bool = False, dropout=None):
    """F3 (see the module doc), differentiable in l (not in mask_bias).

    l: (B, heads, Sq, Sk) bfloat16 or float32 with Sk <= MAX_SK (it raises
    above); mask_bias: float32, broadcastable to l; scale: the divisor;
    out_dtype: bfloat16 or float32 (bf16 logits take either, f32 logits
    f32); dropout: None or (seed, rate, nbits, block). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check_sk(l)
    if mask_bias.requires_grad:
        raise ValueError("attn_softmax: mask_bias takes no gradient")
    return _AttnSoftmax.apply(l, mask_bias, scale, out_dtype, round_logits,
                              dropout)
