"""F1 and F2: the BERT layer's elementwise chains as two CUDA kernels.

The JAX package has no Pallas kernel here: XLA fuses each chain of
blp_tpu/models/bert.py (the bias add of `_dense` :282 with `poly_gelu` :305
or `jax.nn.gelu`, and the residual add with `_layer_norm` :270), so the
training pass keeps only the bf16 GEMM outputs. Run op by op in PyTorch, the
same chains allocate an f32 tensor at every step (poly-GeLU's Horner loop,
each clamp and product, three per LayerNorm) and autograd saves each of them:
~190 KB a token for a BERT-base training layer under `fast_train`, ~48 KB
without, against ~33 KB with the fused chains.

F1, `bias_act(h, b, act, out_dtype)`: y = act(round_out(h + b)). h is the
GEMM output (bf16, or f32 where tensor parallelism sums f32 partials before
the bias), b f32 or None; the add is f32, rounded to `out_dtype`, and the
activation ("none", "erf" as F.gelu, "poly" as `poly_gelu`) is evaluated in
f32 from that rounded value and rounded again. The backward saves h and b
(nothing for "none"), recomputes the rounded pre-activation, and returns
dh = round_h(round_out(g * act'(pre))) and db, the f32 sum over rows of
round_out(g * act'(pre)); for "none" with h in g's dtype, dh is g and the
kernel only sums db. For "poly", act' is the derivative autograd takes
of `poly_gelu` (the clamps pass gradient on their closed ranges, as torch's
`clamp`), not the exact erf derivative. `head_dim` asks for y head-major:
h (B, S, nh * hd) gives y (B, nh, S, hd), the layout the attention reads
q, k and v in (the TPU package's projection einsum "bsh,hnd->bnsd"), so no
transpose copy follows; the backward takes that layout's cotangent (or k's,
(B, nh, hd, S) in memory, as q k^T's backward leaves it) and writes dh
(B, S, nh * hd) in the launch that sums db.

F2, `add_layer_norm(x, r, scale, bias, eps, out_dtype, dropout)`: y =
LN(round(x + drop(r))) with f32 mean and variance, f32 scale and bias (r
None: LN(x)). `dropout` is None or a hidden dropout site's (seed, rate,
nbits, block), r being the site's tensor: drop(r) = where(keep, round_r(r /
keep_p), 0), with `keep` the site's mask (ops/dropout_rng.py), which is what
models/bert.py `_rng_dropout` computes before an unfused add. It saves the
rounded sum s in its own dtype and the per-row f32 mean and rstd (the
kernel writes s only when a gradient will be taken); the backward returns
ds for x and dr = drop(round_r(ds)) for r (ds without dropout), and dscale
and dbias as f32 sums over rows.

The site kernel, `site_dropout(x, dropout)`: drop(x) alone, for the one
dropout site no fused kernel takes (the embedding output), forward and, on
the cotangent, backward.

The CUDA kernels (csrc/fused_layer.cu) read and write 16-byte vectors,
reduce db, dscale and dbias over rows in a fixed order within the
backward's one launch (F1: a ticket counter names the last block of each
column tile, which adds its chunk partials; F2: a persistent grid meets at
one barrier, then shares the columns), so two calls give the same bits,
and evaluate dropout masks in registers (csrc/dropout_rng.cuh): no mask is
drawn or stored. `bias_act_plain`,
`add_layer_norm_plain` and `site_dropout_plain` are the arithmetic of the
unfused layer. On CPU tensors the forwards run
them, and the backwards recompute them from the saved set and differentiate
them with torch.autograd, so CPU results equal the unfused chain's bit for
bit while saving only the small set; CUDA tensors launch the kernels or
raise. There is no fallback between the two.

The wrappers allocate every output with torch ops and launch on the current
stream: the selective checkpoint policies (models/bert.py) do not see a
ctypes launch, so they recompute it.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from blp_tpu_torch.ops import _cuda, dropout_rng

#: Activation ids of the C entry points.
ACTS = {"none": 0, "erf": 1, "poly": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: Elements a thread moves per step: 16 bytes of bf16.
VEC = 8
#: F2's backward reduces over row chunks of at least this many rows, and
#: into at most MAX_CHUNKS chunk partials, which the same launch adds.
MIN_CHUNK_ROWS, MAX_CHUNKS = 32, 1024
#: F1's backward: a block a row chunk of a multiple of F1_CHUNK_ROWS rows,
#: at most F1_MAX_CHUNKS chunks, whose partials the launch's last block of
#: each column tile adds; a tile's ticket a F1_TILE_COLS columns (the kernel
#: refuses a ticket buffer too short for its tiles).
F1_CHUNK_ROWS, F1_MAX_CHUNKS, F1_TILE_COLS = 64, 256, 64
#: Layouts of F1's cotangent (the C entry's ids): row-major (rows, w);
#: head-major (B, nh, S, hd); and head-major held as (B, nh, hd, S), as q
#: k^T's backward leaves k's.
G_LAYOUTS = {"rows": 0, "heads": 1, "heads_t": 2}
#: F2's kernel holds a row in one warp's registers: 16 vectors a lane.
MAX_LN_WIDTH = 4096

#: Kernel launches since the last reset, per wrapper (plain counters;
#: chip_smoke.py reads them), and the same launches by kernel and variant:
#: ("bias_act", "<act> <h dtype>-><out dtype>[ heads]"), ("add_layer_norm",
#: "slab <x+r, x+drop<nbits>(r) or x>[ no s] <x dtype>-><out dtype> w<width>"),
#: their "... backward" kernels (F1's with its cotangent's layout, " heads"
#: or " heads_t", when head-major), and ("site_dropout", "<dtype>
#: drop<nbits>").
bias_act_launches = 0
bias_act_backward_launches = 0
add_layer_norm_launches = 0
add_layer_norm_backward_launches = 0
site_dropout_launches = 0
launches_by_variant: collections.Counter = collections.Counter()


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


def _act_plain(pre, act: str):
    if act == "none":
        return pre
    if act == "erf":
        return F.gelu(pre)
    if act == "poly":
        return poly_gelu(pre)
    raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")


def to_heads(y, head_dim: int):
    """(B, S, nh * hd) -> (B, nh, S, hd), contiguous: the head-major layout
    of q, k and v (the TPU package's einsum "bsh,hnd->bnsd")."""
    B, S, w = y.shape
    return y.reshape(B, S, w // head_dim, head_dim).permute(0, 2, 1, 3).contiguous()


def from_heads(g):
    """(B, nh, S, hd) -> (B, S, nh * hd): a head-major tensor's rows."""
    B, nh, S, hd = g.shape
    return g.permute(0, 2, 1, 3).reshape(B, S, nh * hd)


def bias_act_plain(h, b, act: str, out_dtype, head_dim=None):
    """F1's function in plain PyTorch: the bias added in f32, rounded to
    out_dtype, then the activation in f32 from the rounded value; with
    `head_dim`, h (B, S, nh * hd) gives y head-major (B, nh, S, hd)."""
    pre = h.to(torch.float32)
    if b is not None:
        pre = pre + b
    y = _act_plain(pre.to(out_dtype), act)
    return y if head_dim is None else to_heads(y, head_dim)


def _layer_norm_stats(s, scale, bias, eps: float, out_dtype):
    """LayerNorm of s with float32 statistics, and its (rows, 1) f32 mean
    and rstd; `out_dtype` (None: f32) is the dtype the residual stream is
    carried in."""
    x32 = s.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (x32 - mean) * rstd * scale + bias
    return (out.to(out_dtype) if out_dtype is not None else out), mean, rstd


def site_dropout_plain(x, dropout):
    """drop(x) of the dropout site (seed, rate, nbits, block) in plain
    PyTorch: x / keep_p where the plain generator's mask keeps, 0
    elsewhere, in x's dtype."""
    seed, rate, nbits, block = dropout
    keep, keep_p = dropout_rng.site_keep(seed, rate, nbits, x.shape, block, x.device)
    return torch.where(keep, x / keep_p, 0.0)


def add_layer_norm_plain(x, r, scale, bias, eps: float, out_dtype=None,
                         dropout=None):
    """F2's function in plain PyTorch: LayerNorm of x + drop(r) (of x when r
    is None) with float32 statistics."""
    if dropout is not None:
        r = site_dropout_plain(r, dropout)
    s = x if r is None else x + r
    return _layer_norm_stats(s, scale, bias, eps, out_dtype)[0]


# -- the kernels ---------------------------------------------------------------

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: A dropout site's arguments (dropout_rng.kernel_args, then the call's first
#: flat index in the site).
_DROP = [ctypes.c_uint, ctypes.c_uint, _I, ctypes.c_uint, _F, ctypes.c_ulonglong]
#: ctypes signatures of the C entry points, bound once at first use.
_SIGNATURES = {
    "bias_act_forward": [_P] * 3 + [_L] + [_I] * 6 + [_P],
    "bias_act_backward": [_P] * 7 + [_L] + [_I] * 10 + [_P],
    "add_layer_norm_forward": [_P] * 8 + [_L] + [_I] * 3 + [_F] + _DROP + [_P],
    "add_layer_norm_backward": [_P] * 10 + [_L] + [_I] * 5 + _DROP + [_P],
    "site_dropout_apply": [_P, _P, _L, _I] + _DROP + [_P],
}
_entry: dict = {}


def _bound(name: str):
    """The C entry point `name` of csrc/fused_layer.cu with its signature."""
    fn = _entry.get(name)
    if fn is None:
        lib = _cuda.load("fused_layer")
        for sym, argtypes in _SIGNATURES.items():
            f = getattr(lib, sym)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            _entry[sym] = f
        fn = _entry[name]
    return fn


def chunk_rows(rows: int) -> int:
    """Rows F2's backward block reduces into one partial of dscale and
    dbias: at least MIN_CHUNK_ROWS, and enough for at most MAX_CHUNKS
    chunks. A function of the row count alone, so the reduction order is
    too."""
    return max(MIN_CHUNK_ROWS, -(-rows // MAX_CHUNKS))


def f1_chunk_rows(rows: int) -> int:
    """Rows F1's backward reduces into one partial of db: a multiple of
    F1_CHUNK_ROWS, enough for at most F1_MAX_CHUNKS chunks; a function of
    the row count alone."""
    per = -(-rows // F1_MAX_CHUNKS)
    return max(F1_CHUNK_ROWS, -(-per // F1_CHUNK_ROWS) * F1_CHUNK_ROWS)


def _dtype_id(t_dtype, what: str) -> int:
    if t_dtype not in _DTYPES:
        raise TypeError(f"fused_layer: {what} must be float32 or bfloat16, "
                        f"got {t_dtype}")
    return _DTYPES[t_dtype]


def _rows(t, w: int, what: str):
    """t as a contiguous (rows, w) tensor on t's CUDA device, 16-byte
    aligned: a non-contiguous tensor is copied; a misaligned one raises."""
    if not t.is_cuda:
        raise ValueError(f"fused_layer: {what} is not on a CUDA device")
    if w % VEC:
        raise ValueError(f"fused_layer: width {w} of {what} is not a multiple "
                         f"of {VEC} (the kernels move {VEC}-element vectors)")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"fused_layer: {what} is not 16-byte aligned "
                         f"(address {t.data_ptr():#x})")
    return t.reshape(-1, w)


def _vector(v, w: int, device, what: str):
    """A per-column (w,) f32 vector on `device` (None stays None)."""
    if v is None:
        return None
    if tuple(v.shape) != (w,):
        raise ValueError(f"fused_layer: {what} {tuple(v.shape)} is not ({w},)")
    v = v.to(device, torch.float32)
    return _rows(v, w, what).reshape(w)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _drop_args(dropout, shape) -> tuple:
    """A kernel's dropout arguments for a tensor of `shape` that is its site
    or a block of whole rows of it."""
    offset = 0 if dropout is None else dropout_rng.row_offset(shape, dropout[3])
    return (*dropout_rng.kernel_args(dropout), offset)


def _heads_shape(t, head_dim: int, what: str):
    """(B, S, nh) of a (B, S, nh * head_dim) tensor; head_dim a multiple of
    8 (the kernels' vectors stay in one head)."""
    if t.dim() != 3 or head_dim <= 0 or t.shape[-1] % head_dim:
        raise ValueError(f"fused_layer: {what} {tuple(t.shape)} is not (B, S, "
                         f"heads x {head_dim})")
    if head_dim % VEC:
        raise ValueError(f"fused_layer: head_dim {head_dim} is not a multiple "
                         f"of {VEC} (a kernel vector stays in one head)")
    return t.shape[0], t.shape[1], t.shape[2] // head_dim


def _bias_act_kernel(h, b, act: str, out_dtype, head_dim=None):
    """y; with head_dim, head-major (B, nh, S, hd) from h (B, S, nh * hd)
    ("none" only: the layout of q, k and v)."""
    global bias_act_launches
    w = h.shape[-1]
    seq = 0
    if head_dim is not None:
        B, seq, nh = _heads_shape(h, head_dim, "h")
        if act != "none":
            raise ValueError("fused_layer: a head-major y takes act 'none'")
    h2 = _rows(h, w, "h")
    b = _vector(b, w, h.device, "b")
    shape = h.shape if head_dim is None else (B, nh, seq, head_dim)
    y = torch.empty(shape, dtype=out_dtype, device=h.device)
    if h2.numel() == 0:      # an empty grid is not a valid launch
        return y
    err = _bound("bias_act_forward")(
        h2.data_ptr(), _ptr(b), y.data_ptr(), h2.shape[0], w,
        _dtype_id(h.dtype, "h"), _dtype_id(out_dtype, "out_dtype"), ACTS[act],
        seq, head_dim or 0, _stream(h.device))
    _cuda.check(err, "bias_act launch")
    bias_act_launches += 1
    launches_by_variant["bias_act", f"{act} {_NAMES[h.dtype]}->{_NAMES[out_dtype]}"
                        + ("" if head_dim is None else " heads")] += 1
    return y


#: The backwards' counters by (kernel, device, stream), zeros when made:
#: F1's tickets, one per column tile, which its launch sets back to 0; F2's
#: F2_STATE words (the blocks arrived over all its launches, and that count
#: when the running launch began), which each launch carries on.
_tickets: dict = {}
F2_STATE = 2


def _ticket_buffer(kind: str, device, words: int):
    key = (kind, device.index, _stream(device))
    buf = _tickets.get(key)
    if buf is None or buf.numel() < words:
        buf = _tickets[key] = torch.zeros(max(words, 64), dtype=torch.int32,
                                          device=device)
    return buf


def _g_layout(g, head_dim):
    """(layout, g) of F1's cotangent: "rows"; "heads" for a contiguous
    (B, nh, S, hd); "heads_t" for one held as (B, nh, hd, S) with S a
    multiple of 8; any other head-major tensor is copied to "heads"."""
    if head_dim is None:
        return "rows", g
    if g.dim() != 4 or g.shape[-1] != head_dim:
        raise ValueError(f"fused_layer: a head-major g {tuple(g.shape)} is not "
                         f"(B, heads, S, {head_dim})")
    if g.is_contiguous():
        return "heads", g
    if g.transpose(-1, -2).is_contiguous() and g.shape[2] % VEC == 0:
        return "heads_t", g
    return "heads", g.contiguous()


def _bias_act_backward_kernel(g, h, b, act: str, h_dtype, with_db: bool,
                              head_dim=None):
    """(dh, db) from the cotangent g of y. h and b are read only to
    recompute the pre-activation (act != "none"); db is None unless
    `with_db`. For "none" with h in g's dtype and g row-major, dh is g
    itself (both rounds are exact), and the kernel only reduces db. With
    head_dim, g is head-major (B, nh, S, hd) (as `_g_layout` takes it) and
    dh is (B, S, nh * hd), written by the same launch that sums db."""
    global bias_act_backward_launches
    layout, g = _g_layout(g, head_dim)
    dh_is_g = act == "none" and h_dtype == g.dtype and layout == "rows"
    if dh_is_g and not with_db:
        return g, None
    if layout == "rows":
        w, seq = g.shape[-1], 0
        g2 = _rows(g, w, "g")
        dh_shape = g.shape
    else:
        if act != "none":
            raise ValueError("fused_layer: a head-major g takes act 'none'")
        B, nh, seq, _ = g.shape
        w = nh * head_dim
        g2 = g if layout == "heads" else g.transpose(-1, -2)
        g2 = _rows(g2, g2.shape[-1], "g")
        dh_shape = (B, seq, w)
    h2 = None if act == "none" else _rows(h, w, "h")
    b = None if act == "none" else _vector(b, w, g.device, "b")
    dh = g if dh_is_g else torch.empty(dh_shape, dtype=h_dtype, device=g.device)
    rows = g2.numel() // w
    chunk = f1_chunk_rows(rows)
    n_chunks = -(-rows // chunk)
    f32 = dict(dtype=torch.float32, device=g.device)
    if rows == 0:
        return dh, torch.zeros(w, **f32) if with_db else None
    # The launch writes every column of db.
    partial = torch.empty((n_chunks, w), **f32) if with_db else None
    db = torch.empty(w, **f32) if with_db else None
    tiles = -(-w // F1_TILE_COLS)
    tickets = _ticket_buffer("f1", g.device, tiles) if with_db else None
    err = _bound("bias_act_backward")(
        g2.data_ptr(), _ptr(h2), _ptr(b), None if dh_is_g else dh.data_ptr(),
        _ptr(partial), _ptr(db), _ptr(tickets), rows, w, _dtype_id(h_dtype, "h"),
        _dtype_id(g.dtype, "g"), ACTS[act], chunk, int(with_db), G_LAYOUTS[layout],
        seq, head_dim or 0, 0 if tickets is None else tickets.numel(),
        _stream(g.device))
    _cuda.check(err, "bias_act backward launch")
    bias_act_backward_launches += 1
    launches_by_variant["bias_act backward",
                        f"{act} {_NAMES[h_dtype]}->{_NAMES[g.dtype]}"
                        + ("" if layout == "rows" else f" {layout}")] += 1
    return dh, db


def _add_layer_norm_kernel(x, r, scale, bias, eps: float, out_dtype,
                           dropout=None, keep_sum: bool = True):
    """(y, s, mean, rstd); x and r share a dtype (r may be None, s is then
    x; `dropout` applies to r). keep_sum False: no backward needs the sum,
    which is then not written (s is None)."""
    global add_layer_norm_launches
    w = x.shape[-1]
    if w > MAX_LN_WIDTH:
        raise ValueError(f"fused_layer: width {w} of x is above {MAX_LN_WIDTH} "
                         "(add_layer_norm holds a row in one warp's registers)")
    if dropout is not None and r is None:
        raise ValueError("fused_layer: add_layer_norm's dropout applies to r")
    x2 = _rows(x, w, "x")
    r2 = None if r is None else _rows(r, w, "r")
    scale = _vector(scale, w, x.device, "scale")
    bias = _vector(bias, w, x.device, "bias")
    drop = _drop_args(dropout, x.shape)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = x if r is None else (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                             if keep_sum else None)
    stat = dict(dtype=torch.float32, device=x.device)
    mean = torch.empty(x.shape[:-1] + (1,), **stat)
    rstd = torch.empty(x.shape[:-1] + (1,), **stat)
    if x2.numel() == 0:
        return y, s, mean, rstd
    err = _bound("add_layer_norm_forward")(
        x2.data_ptr(), _ptr(r2), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), None if r is None else _ptr(s), mean.data_ptr(),
        rstd.data_ptr(), x2.shape[0], w, _dtype_id(x.dtype, "x"),
        _dtype_id(out_dtype, "out_dtype"), eps, *drop, _stream(x.device))
    _cuda.check(err, "add_layer_norm launch")
    add_layer_norm_launches += 1
    what = ("x" if r is None else
            ("x+r" if dropout is None else f"x+drop{dropout[2]}(r)")
            + ("" if keep_sum else " no s"))
    # "slab": the forward's design (a block a slab of rows copied in bulk),
    # which takes every call
    launches_by_variant["add_layer_norm", f"slab {what} {_NAMES[x.dtype]}->"
                        f"{_NAMES[out_dtype]} w{w}"] += 1
    return y, s, mean, rstd


def _add_layer_norm_backward_kernel(g, s, mean, rstd, scale, dropout=None):
    """(ds, dr, dscale, dbias) from the cotangent g of y; dr (s's dtype) is
    None without dropout."""
    global add_layer_norm_backward_launches
    w = s.shape[-1]
    g2 = _rows(g, w, "g")
    s2 = _rows(s, w, "s")
    rows = s2.shape[0]
    mean, rstd = mean.contiguous(), rstd.contiguous()
    scale = _vector(scale, w, s.device, "scale")
    drop = _drop_args(dropout, s.shape)
    ds = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    dr = None if dropout is None else torch.empty_like(ds)
    n_chunks = -(-rows // chunk_rows(rows))
    f32 = dict(dtype=torch.float32, device=s.device)
    if rows == 0:                          # no rows: dscale = dbias = 0
        dsb = torch.zeros(2 * w, **f32)
        return ds, dr, dsb[:w], dsb[w:]
    # The launch writes every column of dscale, then dbias.
    partial = torch.empty((n_chunks, 2 * w), **f32)
    dsb = torch.empty(2 * w, **f32)
    state = _ticket_buffer("f2", s.device, F2_STATE)
    err = _bound("add_layer_norm_backward")(
        g2.data_ptr(), s2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        scale.data_ptr(), ds.data_ptr(), _ptr(dr), partial.data_ptr(),
        dsb.data_ptr(), state.data_ptr(), rows, w, _dtype_id(s.dtype, "s"),
        _dtype_id(g.dtype, "g"), chunk_rows(rows), state.numel(), *drop,
        _stream(s.device))
    _cuda.check(err, "add_layer_norm backward launch")
    add_layer_norm_backward_launches += 1
    kind = "" if dropout is None else f" drop{dropout[2]}"
    launches_by_variant["add_layer_norm backward",
                        f"{_NAMES[s.dtype]}->{_NAMES[g.dtype]}{kind}"] += 1
    return ds, dr, dsb[:w], dsb[w:]


def _site_dropout_kernel(x, dropout):
    """drop(x) by the site kernel."""
    global site_dropout_launches
    x2 = _rows(x, x.shape[-1], "x")
    drop = _drop_args(dropout, x.shape)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x2.numel() == 0:
        return y
    err = _bound("site_dropout_apply")(
        x2.data_ptr(), y.data_ptr(), x2.numel(), _dtype_id(x.dtype, "x"), *drop,
        _stream(x.device))
    _cuda.check(err, "site_dropout launch")
    site_dropout_launches += 1
    launches_by_variant["site_dropout", f"{_NAMES[x.dtype]} drop{dropout[2]}"] += 1
    return y


# -- autograd ------------------------------------------------------------------

class _BiasAct(torch.autograd.Function):
    """F1. Saves h and b (nothing for act "none")."""

    @staticmethod
    def forward(ctx, h, b, act, out_dtype, head_dim):
        ctx.act, ctx.h_dtype, ctx.out_dtype = act, h.dtype, out_dtype
        ctx.head_dim = head_dim
        ctx.b_shape = None if b is None else b.shape
        ctx.save_for_backward(*(() if act == "none" else (h, b)))
        if h.is_cuda:
            return _bias_act_kernel(h, b, act, out_dtype, head_dim)
        return bias_act_plain(h, b, act, out_dtype, head_dim)

    @staticmethod
    def backward(ctx, g):
        h, b = ctx.saved_tensors if ctx.act != "none" else (None, None)
        with_db = ctx.b_shape is not None and ctx.needs_input_grad[1]
        if g.is_cuda:
            dh, db = _bias_act_backward_kernel(g, h, b, ctx.act, ctx.h_dtype,
                                               with_db, ctx.head_dim)
            return dh, db, None, None, None
        # The unfused chain's backward, re-run on the recomputed
        # pre-activation: the same ops, hence the same bits.
        dpre = g if ctx.head_dim is None else from_heads(g)
        if ctx.act != "none":
            with torch.enable_grad():
                pre = bias_act_plain(h, b, "none", ctx.out_dtype)
                pre = pre.detach().requires_grad_()
                dpre, = torch.autograd.grad(_act_plain(pre, ctx.act), pre, dpre)
        d32 = dpre.to(torch.float32)
        db = d32.sum_to_size(ctx.b_shape) if with_db else None
        return d32.to(ctx.h_dtype), db, None, None, None


class _AddLayerNorm(torch.autograd.Function):
    """F2. Saves the rounded sum s, the per-row mean and rstd, and scale and
    bias (parameters, not activations); with dropout only the site's seed
    besides, as the mask is evaluated again in the backward."""

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps, out_dtype, dropout, keep_sum):
        ctx.eps, ctx.out_dtype, ctx.dropout = eps, out_dtype, dropout
        ctx.dtypes = (x.dtype, None if r is None else r.dtype)
        if x.is_cuda:
            if r is not None and r.dtype != x.dtype:
                # x + r in its promoted dtype: both cast up exactly first.
                # The kernel drops r in that dtype, so a dropped r must be
                # the wider one, as the layer's always is.
                st = torch.promote_types(x.dtype, r.dtype)
                if dropout is not None and r.dtype != st:
                    raise TypeError(f"fused_layer: a dropped r ({r.dtype}) "
                                    f"narrower than x ({x.dtype})")
                x, r = x.to(st), r.to(st)
            y, s, mean, rstd = _add_layer_norm_kernel(
                x, r, scale, bias, eps, out_dtype, dropout, keep_sum)
        else:
            if dropout is not None:
                r = site_dropout_plain(r, dropout)
            s = x if r is None else x + r
            y, mean, rstd = _layer_norm_stats(s, scale, bias, eps, out_dtype)
        ctx.save_for_backward(s, mean, rstd, scale, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        s, mean, rstd, scale, bias = ctx.saved_tensors
        x_dt, r_dt = ctx.dtypes
        if g.is_cuda:
            ds, dr, dscale, dbias = _add_layer_norm_backward_kernel(
                g, s, mean, rstd, scale, ctx.dropout)
        else:
            # The unfused LayerNorm's backward on the saved sum, then the
            # dropout's (`_rng_dropout`'s) on the branch.
            need = ctx.needs_input_grad
            with torch.enable_grad():
                s_ = s.detach().requires_grad_()
                sc = scale.detach().requires_grad_(need[2])
                bi = bias.detach().requires_grad_(need[3])
                y = _layer_norm_stats(s_, sc, bi, ctx.eps, ctx.out_dtype)[0]
                wrt = [t for t in (s_, sc, bi) if t.requires_grad]
                got = iter(torch.autograd.grad(y, wrt, g))
                ds = next(got)
                dscale = next(got) if need[2] else None
                dbias = next(got) if need[3] else None
            dr = (None if ctx.dropout is None
                  else site_dropout_plain(ds.to(r_dt), ctx.dropout))
        dr = ds if dr is None else dr        # without dropout, r's is ds
        return (ds.to(x_dt), None if r_dt is None else dr.to(r_dt),
                dscale, dbias, None, None, None, None)


class _SiteDropout(torch.autograd.Function):
    """The site kernel as a Function: drop(x) forward, drop(g) backward, the
    mask evaluated again from the seed (nothing saved)."""

    @staticmethod
    def forward(ctx, x, dropout):
        ctx.dropout = dropout
        if x.is_cuda:
            return _site_dropout_kernel(x, dropout)
        return site_dropout_plain(x, dropout)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            return _site_dropout_kernel(g, ctx.dropout), None
        return site_dropout_plain(g, ctx.dropout), None


def bias_act(h, b, act: str = "none", out_dtype=torch.float32, head_dim=None):
    """F1: act(round_out(h + b)), differentiable in h and b.

    h: (..., w) float32 or bfloat16 (the GEMM output); b: (w,) (f32 on the
    kernel), or None for no bias; act: "none", "erf" or "poly"; out_dtype:
    float32 or bfloat16; head_dim: None for y in h's shape, or the head
    width for y head-major (B, w / head_dim, S, head_dim) from h (B, S, w),
    act "none" (q, k and v). The kernel on CUDA tensors (w and head_dim
    multiples of 8, 16-byte aligned rows; it raises otherwise), the plain
    version on CPU tensors."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return _BiasAct.apply(h, b, act, out_dtype, head_dim)


def add_layer_norm(x, r, scale, bias, eps: float, out_dtype=None, dropout=None):
    """F2: LayerNorm of x + drop(r) (of x when r is None) with float32
    statistics, differentiable in x, r, scale and bias; out_dtype None is
    float32.

    x, r: (..., H) float32 or bfloat16; scale, bias: (H,); dropout: None or
    r's dropout site (seed, rate, nbits, block), block None or the (whole
    shape, start) of a run of whole rows of the site. The kernel on CUDA
    tensors (H a multiple of 8 up to 4,096, 16-byte aligned rows; it raises
    otherwise), the plain version on CPU tensors."""
    # Without a gradient to take (an encode) the kernel does not write the
    # sum the backward would read.
    keep_sum = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, r, scale, bias))
    return _AddLayerNorm.apply(x, r, scale, bias, eps,
                               torch.float32 if out_dtype is None else out_dtype,
                               dropout, keep_sum)


def site_dropout(x, dropout):
    """drop(x) for the dropout site (seed, rate, nbits, block) (block None or
    a run of whole rows of the site), differentiable: the site kernel on
    CUDA tensors (the last dimension a multiple of 8, 16-byte aligned), the
    plain version on CPU tensors."""
    return _SiteDropout.apply(x, dropout)
