"""The dropout masks of the training pass: one counter-based generator
(Philox4x32-10), evaluated where each mask is used.

The JAX package draws each site's bits with `jax.random` (threefry or rbg)
in an op of their own, because on the TPU "the rng-bit-generator op cannot
fuse into its consumers" (blp_tpu/models/bert.py:183-190). On the card a
kernel makes its own bits: F3 (ops/attn_softmax.py), F2 (ops/fused_layer.py
`add_layer_norm`) and the site kernel (`fused_layer.site_dropout`) evaluate
the same function in registers (csrc/dropout_rng.cuh), forward and
backward, so no mask is drawn with torch's generator or kept in memory. This module is
that function in plain PyTorch: the CPU tests run it, and on the card it
runs only in the checks that hold the kernels to it.

The keep bit of element n of a dropout site depends on three things only:
the site's seed (a 63-bit integer from `utils.fold_seed`), n, the flat index
of the element in the WHOLE site's shape ((B, heads, Sq, Sk) at the
attention site, (B, S, H) at a hidden one), and `dropout_bits`. So the
forward, the backward, a remat recompute and every rank's block of the site
see one mask with no coordination: a block (see `site_keep`) only shifts n.

Layout:
- key = (seed & 0xffffffff, seed >> 32); counter = (q & 0xffffffff, q >> 32,
  0, 0) with q = n // m, where m, the masks a call yields, is 4 at 32 bits, 8
  at 16 and 16 at 8;
- 8 and 16 bits: the field of element n is byte (or half-word) n % m of the
  call's four output words in order, each word little-endian; keep iff the
  field >= t, t from `threshold` (the quantized rate);
- 32 bits: word w = n % 4 gives u = (w >> 8) * 2^-24, keep iff u < keep_p in
  float32 (as `torch.rand(...) < keep_p` would), which is the integer test
  (w >> 8) < ceil(f32(keep_p) * 2^24).

The thresholds, the quantized keep probability and E[dropout(x)] = x are the
ones the port has always had (`threshold` is the TPU package's rule). The
stream itself is new: the port drew its masks from `torch.Generator` before,
and neither stream is JAX's, so the two packages agree in distribution only
(tests/test_torch_dropout_rng.py).
"""

from __future__ import annotations

import math
import struct

import torch

#: Philox4x32's round multipliers and Weyl key increments (Salmon et al.,
#: "Parallel random numbers: as easy as 1, 2, 3", SC 2011; Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
_LO32 = 0xFFFFFFFF
#: Masks one Philox call yields, by dropout_bits.
MASKS_PER_CALL = {32: 4, 16: 8, 8: 16}


def threshold(rate: float, nbits: int) -> tuple[int | None, float]:
    """(threshold t, keep probability) of a dropout mask. nbits=32: a
    bernoulli draw with keep probability 1 - rate (t is None). nbits=8/16:
    keep iff bits >= t with t = min(round(rate·2^n), 2^n - 1), so the drop
    probability quantizes to t/2^n and the keep rescale uses the quantized
    1 - t/2^n (E[dropout(x)] == x stays exact; the clamp keeps rate -> 1
    from dropping everything)."""
    if nbits == 32:
        return None, 1.0 - rate
    if nbits not in (8, 16):
        raise ValueError(f"dropout_bits must be 8, 16 or 32, got {nbits}")
    levels = 1 << nbits
    t = min(int(round(rate * levels)), levels - 1)
    return t, 1.0 - t / levels


def compare_threshold(rate: float, nbits: int) -> tuple[int, float]:
    """(the kernels' integer threshold, keep probability): t at 8 and 16
    bits (keep iff field >= t), ceil(f32(keep_p) * 2^24) at 32 (keep iff
    (w >> 8) < it)."""
    t, keep_p = threshold(rate, nbits)
    if t is not None:
        return t, keep_p
    kp32 = struct.unpack("f", struct.pack("f", keep_p))[0]
    return math.ceil(kp32 * (1 << 24)), keep_p


def key_of(seed: int) -> tuple[int, int]:
    """Philox's key from a site seed: its low and high 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"a dropout seed is a 64-bit unsigned integer, got {seed}")
    return seed & _LO32, seed >> 32


def _mulhilo(m: int, b):
    """(hi, lo) 32-bit words of the 64-bit product m * b, m a 32-bit
    constant and b an int64 tensor of 32-bit values. m * b overflows int64,
    so b is split into 16-bit halves: each partial product is below 2^48."""
    t = m * (b & 0xFFFF)
    u = m * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(counter, key: tuple[int, int], rounds: int = ROUNDS):
    """Philox4x32-`rounds` of a batch of counters: `counter` is four int64
    tensors of 32-bit words (broadcastable), `key` two ints; returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(rounds):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & _LO32, (k1 + PHILOX_W[1]) & _LO32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def element_index(shape, block=None, device=None):
    """The flat index in the whole site of every element of a tensor of
    `shape` (int64, that shape). `block` is None when the tensor is the whole
    site, else (whole shape, start): the tensor is the block of the whole
    site that starts at index `start` along each dimension."""
    shape = tuple(int(s) for s in shape)
    whole, start = _whole_and_start(shape, block)
    if any(s0 < 0 or s0 + s > w for s, w, s0 in zip(shape, whole, start)):
        raise ValueError(f"dropout block {block} does not hold a tensor of {shape}")
    n = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        idx = torch.arange(start[d], start[d] + shape[d], dtype=torch.int64,
                           device=device) * stride
        n = n + idx.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= whole[d]
    return n.expand(shape)


def keep_of(seed: int, nbits: int, cut: int, n):
    """The keep bits (bool, n's shape) of the site elements at flat indices
    n, for the integer threshold `cut` of `compare_threshold`. Philox runs
    once for each counter from the least to the largest that n needs."""
    m = MASKS_PER_CALL[nbits]
    if n.numel() == 0:
        return torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    q = torch.div(n, m, rounding_mode="floor")
    q0, q1 = int(q.min()), int(q.max())
    qs = torch.arange(q0, q1 + 1, dtype=torch.int64, device=n.device)
    zero = torch.zeros((), dtype=torch.int64, device=n.device)
    words = torch.stack(philox4x32((qs & _LO32, qs >> 32, zero, zero),
                                   key_of(seed)), dim=-1)        # (calls, 4)
    sub = n - q * m                        # the mask's place in its call
    per = m // 4                           # masks a word
    w = words[q - q0, torch.div(sub, per, rounding_mode="floor")]
    if nbits == 32:
        return (w >> 8) < cut
    field = (w >> (nbits * (sub % per))) & ((1 << nbits) - 1)
    return field >= cut


def site_keep(seed: int, rate: float, nbits: int, shape, block=None,
              device=None):
    """(keep mask, keep probability) of a dropout site's elements: the
    tensor of `shape` on `device` that is the whole site (`block` None) or
    its block (whole shape, start) (see `element_index`)."""
    cut, keep_p = compare_threshold(rate, nbits)
    return keep_of(seed, nbits, cut, element_index(shape, block, device)), keep_p


# -- the kernels' arguments ------------------------------------------------------

#: The generator arguments of a call without dropout.
NO_DROPOUT = (0, 0, 0, 0, 1.0)


def kernel_args(dropout) -> tuple[int, int, int, int, float]:
    """(seed low word, seed high word, nbits, integer threshold, keep_p) of
    a dropout site (seed, rate, nbits, block), as the kernels take them
    (csrc/dropout_rng.cuh); NO_DROPOUT for None."""
    if dropout is None:
        return NO_DROPOUT
    seed, rate, nbits, _ = dropout
    cut, keep_p = compare_threshold(rate, nbits)
    return (*key_of(seed), nbits, cut, keep_p)


def _whole_and_start(shape, block):
    shape = tuple(int(s) for s in shape)
    if block is None:
        return shape, (0,) * len(shape)
    whole, start = (tuple(int(v) for v in b) for b in block)
    if len(whole) != len(shape) or len(start) != len(shape):
        raise ValueError(f"dropout block {block} does not hold a tensor of {shape}")
    return whole, start


def row_offset(shape, block) -> int:
    """The whole site's flat index of the first element of a tensor of
    `shape` that is a run of whole rows of the site (`block` None or (whole,
    start) with only start[0] nonzero): where a kernel that walks the tensor
    in order starts its element index."""
    whole, start = _whole_and_start(shape, block)
    if any(start[1:]) or whole[1:] != tuple(shape)[1:]:
        raise ValueError(f"dropout block {block}: a kernel takes a block of whole "
                         f"rows of the site, not of {tuple(shape)}")
    return start[0] * math.prod(whole[1:])


def head_block(shape, block) -> tuple[int, int, int]:
    """(first row, first head, whole site's heads) of an attention tensor
    (B, heads, Sq, Sk) that is a block of rows and heads of its site."""
    whole, start = _whole_and_start(shape, block)
    if len(whole) != 4 or any(start[2:]) or whole[2:] != tuple(shape)[2:]:
        raise ValueError(f"dropout block {block}: F3 takes a block of rows and "
                         f"heads of the site, not of {tuple(shape)}")
    return start[0], start[1], whole[1]
