"""The word tables' row gather, whose backward is a hand-written segmented sum.

`gather_rows(table, ids)` is `table[ids]`: the same gather, the same bits.
Only its backward differs on the card. torch's backward of advanced indexing
sorts the ids and then adds every duplicate of one id in one serial loop
(`indexing_backward_kernel`), so its time follows the longest run of one
id. Every padded position of a description gathers row 0, so at the W5M
train step (131,072 positions, ~9% of them padding) that one run of ~11,700
serial adds took ~8.4 ms a step.

Here the backward of a CUDA table is torch's stable sort of the flattened
ids and one hand-written kernel (csrc/row_gather.cu, `index_put_segsum`):
the sorted positions are cut into chunks of CHUNK; a block adds its chunk's
runs in sorted order in f32; a run inside one chunk is written straight to
its row, and a run that crosses chunks leaves one partial a chunk, which
the block that finishes last among them adds in chunk order. Untouched rows
are zero (the wrapper's zero fill). No float atomics: the same bits on
every call. `segment_sum_plain` is that arithmetic in PyTorch, in the same
order, so the kernel equals it bit for bit. The JAX package has no Pallas
kernel here: XLA does the VJP's scatter-add.

Routing: a CPU table, or a gather that needs no gradient, is `table[ids]`
as it was (the CPU's gradient is autograd's, as before); a CUDA table that
needs one takes the Function, whose backward launches the kernel or raises
(float32 gradients only). There is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from blp_tpu_torch.ops import _cuda

#: Sorted positions a chunk spans (csrc/row_gather.cu kChunk; a card test
#: holds the two equal).
CHUNK = 128

#: Kernel launches since the last reset (a plain counter, read to show that
#: the main path went through the kernel).
launches = 0


def segment_sum_plain(g, ids, num_rows: int):
    """The gradient of `table[ids]` for a (num_rows, E) table against the
    cotangent g (ids.shape + (E,)): zeros, then g's rows added into the rows
    that ids name, in the kernel's order. The ids are sorted stably; each
    run of one id is cut at the multiples of CHUNK into pieces, each piece
    summed from 0 in sorted order, and the run's pieces summed from 0 in
    order. A sum from 0 never reads -0, so a one-piece run's row is its
    piece's sum, as the kernel writes it."""
    E = g.shape[-1]
    g = g.reshape(-1, E)
    out = torch.zeros((num_rows, E), dtype=g.dtype, device=g.device)
    n = g.shape[0]
    if n == 0:
        return out
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    rows = g[order]
    pos = torch.arange(n, device=g.device)
    new_run = torch.ones(n, dtype=torch.bool, device=g.device)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    piece_start = torch.nonzero(new_run | (pos % CHUNK == 0)).squeeze(1)
    piece_len = torch.diff(piece_start, append=torch.tensor([n], device=g.device))
    pieces = torch.zeros((piece_start.numel(), E), dtype=g.dtype, device=g.device)
    for t in range(int(piece_len.max())):
        m = piece_len > t
        pieces[m] = pieces[m] + rows[piece_start[m] + t]
    run_first = torch.nonzero(new_run[piece_start]).squeeze(1)
    run_pieces = torch.diff(run_first, append=torch.tensor(
        [piece_start.numel()], device=g.device))
    sums = torch.zeros((run_first.numel(), E), dtype=g.dtype, device=g.device)
    for t in range(int(run_pieces.max())):
        m = run_pieces > t
        sums[m] = sums[m] + pieces[run_first[m] + t]
    out[sorted_ids[piece_start[run_first]]] = sums
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
_entry: dict = {}


def _bound(name: str):
    """The C entry point `name` of csrc/row_gather.cu with its signature set."""
    fn = _entry.get(name)
    if fn is None:
        lib = _cuda.load("row_gather")
        signatures = {"index_put_segsum_launch": [_P] * 3 + [_I] * 3 + [_P] * 5,
                      "index_put_segsum_slabs": [_I, _I]}
        for sym, argtypes in signatures.items():
            f = getattr(lib, sym)
            f.restype, f.argtypes = ctypes.c_int, argtypes
            _entry[sym] = f
        fn = _entry[name]
    return fn


def segment_sum(g, ids, num_rows: int):
    """`segment_sum_plain` on the card: torch's stable sort of the ids, then
    one launch of `index_put_segsum`. g: float32 CUDA, ids.shape + (E,);
    ids: integers in [0, num_rows) on g's device."""
    global launches
    if g.dtype != torch.float32:
        raise TypeError(f"index_put_segsum takes float32 gradients, got {g.dtype}")
    if not g.is_cuda or ids.device != g.device:
        raise ValueError("index_put_segsum: g and ids must lie on one CUDA device")
    E = g.shape[-1]
    g = g.reshape(-1, E).contiguous()
    n = g.shape[0]
    if n >= 2**31 or num_rows >= 2**31:
        raise ValueError(f"index_put_segsum: {n} positions or {num_rows} rows "
                         "exceed the int32 range")
    out = torch.zeros((num_rows, E), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    sorted_ids, order = torch.sort(ids.reshape(-1).to(torch.int32), stable=True)
    v = 4 if E % 4 == 0 and g.data_ptr() % 16 == 0 else 1
    slabs = _bound("index_put_segsum_slabs")(E, v)
    partials = torch.empty((2 * -(-n // CHUNK), E), dtype=torch.float32,
                           device=g.device)
    run_start = torch.empty(num_rows, dtype=torch.int32, device=g.device)
    arrivals = torch.zeros(num_rows * slabs, dtype=torch.int64, device=g.device)
    err = _bound("index_put_segsum_launch")(
        sorted_ids.data_ptr(), order.data_ptr(), g.data_ptr(), n, E, v,
        out.data_ptr(), partials.data_ptr(), run_start.data_ptr(),
        arrivals.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    _cuda.check(err, "index_put_segsum launch")
    launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum(g, ids, ctx.num_rows), None


def gather_rows(table, ids):
    """table[ids] for a (V, E) table and integer ids of any shape: rows of
    shape ids.shape + (E,). Differentiable in table; on the card its
    gradient is `segment_sum`'s."""
    ids = ids.long()
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, ids)
    return table[ids]
