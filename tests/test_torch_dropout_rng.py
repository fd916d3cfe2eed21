"""The dropout masks of the port's training pass (blp_tpu_torch/ops/
dropout_rng.py): a counter-based generator that F3, F2 and the site kernel
evaluate in registers on the card, here in its plain version on the CPU.

- Philox4x32-10 against Random123's published known answers.
- The masks' statistics: the keep fraction at 8, 16 and 32 bits within 4
  sigma of keep_p (and of every field position of a call), beside JAX's
  `_dropout_keep` drawn the same way; no correlation between neighbouring
  elements or between two sites' seeds (each within 4 sigma of 0).
- The index rule: a block of rows and heads (a data- or tensor-parallel
  rank's part) gets the same slice of the whole site's mask.
- One mask per site: the forward, the backward and a remat recompute apply
  it alike.
- F3 and F2 with dropout equal, bit for bit, the unfused chain (the plain
  softmax or the residual LayerNorm after `_rng_dropout`) with the same
  masks, forward and gradients; and whole 2-layer encoders with the unfused
  chains patched in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from blp_tpu.models import bert as j_bert
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.ops import attn_softmax as f3
from blp_tpu_torch.ops import dropout_rng
from blp_tpu_torch.ops import fused_layer
from blp_tpu_torch.utils import fold_seed

T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(counter, key):
    c = tuple(torch.tensor([w], dtype=torch.int64) for w in counter)
    return [int(w) for w in dropout_rng.philox4x32(c, key)]


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    assert _words(counter, key) == list(want)


def test_mulhilo_splits_without_overflow():
    b = torch.tensor([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x89ABCDEF], dtype=torch.int64)
    for m in dropout_rng.PHILOX_M:
        hi, lo = dropout_rng._mulhilo(m, b)
        assert [(h << 32) | w for h, w in zip(hi.tolist(), lo.tolist())] == [
            m * v for v in b.tolist()]


def test_site_key_and_counter_layout():
    """Element n's bits come from call n // m with key (seed low, seed
    high): the 8-bit field of element 5 is byte 1 of word 1 of call 0."""
    seed = (0x12345678 << 32) | 0x9ABCDEF0
    w = _words((0, 0, 0, 0), (0x9ABCDEF0, 0x12345678))
    t = 77
    keep = dropout_rng.keep_of(seed, 8, t, torch.arange(16))
    assert keep.tolist() == [((w[i // 4] >> (8 * (i % 4))) & 0xFF) >= t
                             for i in range(16)]
    keep = dropout_rng.keep_of(seed, 32, 1 << 23, torch.arange(4, 8))
    w1 = _words((1, 0, 0, 0), (0x9ABCDEF0, 0x12345678))
    assert keep.tolist() == [(x >> 8) < (1 << 23) for x in w1]


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_keep_fraction_within_4_sigma_and_beside_jax(nbits):
    n = 1 << 20
    keep, keep_p = dropout_rng.site_keep(fold_seed(3, nbits), 0.1, nbits, (n,))
    assert keep.dtype == torch.bool
    sigma = (keep_p * (1 - keep_p) / n) ** 0.5
    got = keep.float().mean().item()
    assert abs(got - keep_p) < 4 * sigma
    # Every field position of a call keeps at the same rate.
    m = dropout_rng.MASKS_PER_CALL[nbits]
    per = keep.reshape(-1, m).float().mean(0)
    assert (per - keep_p).abs().max().item() < 4 * sigma * m ** 0.5
    jkeep, jkeep_p = j_bert._dropout_keep(jax.random.key(nbits), 0.1, nbits, (n,))
    assert jkeep_p == keep_p
    jgot = float(jnp.mean(jkeep))
    assert abs(jgot - keep_p) < 4 * sigma
    assert abs(got - jgot) < 4 * sigma * 2 ** 0.5


def _corr(a, b):
    a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
    return (a * b).mean().item() / (a.std().item() * b.std().item())


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_no_correlation_between_neighbours_or_sites(nbits):
    """Lag-1 and lag-m (the next call's same field) correlations of one
    site's mask, and the correlation of two neighbouring sites' masks (a
    layer's three seeds), each within 4 sigma (1 / sqrt(n)) of 0."""
    n = 1 << 20
    seeds = t_bert.layer_seeds(fold_seed(7, 1), 2)
    keep = dropout_rng.site_keep(seeds[0], 0.1, nbits, (n,))[0]
    m = dropout_rng.MASKS_PER_CALL[nbits]
    bound = 4 / n ** 0.5
    assert abs(_corr(keep[1:], keep[:-1])) < bound
    assert abs(_corr(keep[m:], keep[:-m])) < bound
    for other in seeds[1:]:
        keep2 = dropout_rng.site_keep(other, 0.1, nbits, (n,))[0]
        assert abs(_corr(keep, keep2)) < bound
        assert not torch.equal(keep, keep2)


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_a_block_of_rows_and_heads_is_the_slice_of_the_whole_site(nbits):
    whole = (6, 8, 5, 12)
    full = dropout_rng.site_keep(99, 0.3, nbits, whole)[0]
    part = t_bert.Part(rows=(2, 6), model=type("Axis", (), {"rank": 1})())
    x = torch.zeros(3, 4, 5, 12)
    block = part.block(x, heads=8)
    assert block == (whole, (2, 4, 0, 0))
    got = dropout_rng.site_keep(99, 0.3, nbits, x.shape, block)[0]
    assert torch.equal(got, full[2:5, 4:8])
    # A hidden site's block of rows: the kernels' flat offset.
    h = torch.zeros(2, 5, 12)
    hblock = t_bert.Part(rows=(3, 6)).block(h)
    assert dropout_rng.row_offset(h.shape, hblock) == 3 * 5 * 12
    assert torch.equal(dropout_rng.site_keep(5, 0.3, nbits, h.shape, hblock)[0],
                       dropout_rng.site_keep(5, 0.3, nbits, (6, 5, 12))[0][3:5])
    assert dropout_rng.head_block(x.shape, block) == (2, 4, 8)
    with pytest.raises(ValueError, match="whole rows"):
        dropout_rng.row_offset(x.shape, block)


def test_forward_backward_and_remat_apply_one_mask():
    """F2 with dropout: the backward's dr is zero exactly where the
    forward dropped r, and a checkpointed call (its forward run again in
    the backward) gives the same output and gradients."""
    rng = np.random.default_rng(0)
    x, r = (torch.from_numpy(rng.uniform(0.5, 1.5, (7, 16)).astype(np.float32))
            for _ in range(2))
    scale, bias = torch.ones(16), torch.zeros(16)
    drop = (fold_seed(1, 2), 0.3, 16, None)
    gy = torch.from_numpy(rng.standard_normal((7, 16)).astype(np.float32))

    def run(remat):
        xx, rr = x.clone().requires_grad_(), r.clone().requires_grad_()
        fn = lambda a, b: fused_layer.add_layer_norm(a, b, scale, bias, 1e-12,  # noqa: E731
                                                     None, drop)
        y = checkpoint(fn, xx, rr, use_reentrant=False) if remat else fn(xx, rr)
        return (y, *torch.autograd.grad(y, (xx, rr), gy))

    y, dx, dr = run(False)
    keep = dropout_rng.site_keep(drop[0], 0.3, 16, r.shape)[0]
    assert 0 < keep.sum() < keep.numel()
    assert torch.equal(dr == 0, ~keep)
    assert all(torch.equal(a, b) for a, b in zip((y, dx, dr), run(True)))


def _unfused_softmax(l, mask_bias, scale, out_dtype, round_logits=False,
                     dropout=None):
    """The attention chain op by op, its dropout through `_rng_dropout`."""
    p = f3._softmax_plain(l, mask_bias, scale, out_dtype, round_logits)
    return p if dropout is None else t_bert._rng_dropout(p, *dropout)


def _unfused_add_layer_norm(x, r, scale, bias, eps, out_dtype=None, dropout=None):
    """The residual LayerNorm after `_rng_dropout` of its branch."""
    if dropout is not None:
        r = t_bert._rng_dropout(r, *dropout)
    return fused_layer.add_layer_norm(x, r, scale, bias, eps, out_dtype)


@pytest.mark.parametrize("nbits", [8, 16, 32])
@pytest.mark.parametrize("l_dt,out_dt", [("bf16", "bf16"), ("f32", "f32")])
def test_f3_with_dropout_equals_the_unfused_chain(l_dt, out_dt, nbits):
    rng = np.random.default_rng(nbits)
    l = torch.from_numpy(6 * rng.standard_normal((2, 3, 16, 16))).to(T_DT[l_dt])
    bias = torch.zeros(2, 1, 1, 16)
    bias[0, ..., 11:] = -10000.0
    g = torch.from_numpy(rng.standard_normal((2, 3, 16, 16))).to(T_DT[out_dt])
    drop = (fold_seed(4, nbits), 0.2, nbits, ((5, 6, 16, 16), (1, 3, 0, 0)))
    res = []
    for fn in (f3.attn_softmax, _unfused_softmax):
        ll = l.clone().requires_grad_()
        y = fn(ll, bias, 4.0, T_DT[out_dt], dropout=drop)
        res.append((y, *torch.autograd.grad(y, ll, g)))
    for a, w in zip(*res):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("nbits", [8, 16, 32])
@pytest.mark.parametrize("x_dt,r_dt,out_dt", [("bf16", "bf16", "bf16"),
                                              ("f32", "f32", "f32"),
                                              ("bf16", "f32", "bf16")])
def test_f2_with_dropout_equals_the_unfused_chain(x_dt, r_dt, out_dt, nbits):
    rng = np.random.default_rng(10 + nbits)
    x = torch.from_numpy(1 + rng.standard_normal((3, 5, 24))).to(T_DT[x_dt])
    r = torch.from_numpy(0.5 * rng.standard_normal((3, 5, 24))).to(T_DT[r_dt])
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(24)).float()
    bias = torch.from_numpy(0.1 * rng.standard_normal(24)).float()
    g = torch.from_numpy(rng.standard_normal((3, 5, 24))).to(T_DT[out_dt])
    drop = (fold_seed(5, nbits), 0.1, nbits, ((7, 5, 24), (4, 0, 0)))
    res = []
    for fn in (fused_layer.add_layer_norm, _unfused_add_layer_norm):
        ins = [t.clone().requires_grad_() for t in (x, r, scale, bias)]
        y = fn(*ins, 1e-12, T_DT[out_dt], drop)
        res.append((y, *torch.autograd.grad(y, ins, g)))
    for a, w in zip(*res):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_site_kernel_function_equals_the_plain_dropout():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 6, 8))).float().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 6, 8))).float()
    drop = (fold_seed(9, 0), 0.25, 8, ((9, 6, 8), (5, 0, 0)))
    y = fused_layer.site_dropout(x, drop)
    dx, = torch.autograd.grad(y, x, g)
    assert torch.equal(y, fused_layer.site_dropout_plain(x.detach(), drop))
    assert torch.equal(dx, fused_layer.site_dropout_plain(g, drop))


@pytest.mark.parametrize("dtype,kw", [
    ("f32", {}),
    ("bf16", {"dropout_bits": 8}),
    ("bf16", {"mixed_precision_train": False, "dropout_bits": 16}),
    ("bf16", {"fast_train": True, "remat": True, "dropout_bits": 8}),
    ("f32", {"remat": "names", "seq_pack": 1}),
])
def test_encoder_layers_equal_the_unfused_chain(monkeypatch, dtype, kw):
    """A 2-layer encoder's training pass (dropout on at all four sites, a
    part of the rows) with the fused kernels, and with the unfused chains
    patched in: the same output and gradients, bit for bit."""
    cfg = t_bert.BertConfig.tiny(compute_dtype=T_DT[dtype], **kw)
    params = t_bert.init_bert_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 12)))
    mask = torch.from_numpy((np.arange(12)[None] < rng.integers(3, 13, (4, 1)))
                            .astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((4, 12, cfg.hidden_size))
                          .astype(np.float32))
    part = t_bert.Part(rows=(4, 12))

    def run():
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params["layers"].items()}
        p = dict(params, layers=leaves)
        y = t_bert.bert_encode(p, ids, mask, cfg, deterministic=False,
                               dropout_seed=13, part=part)
        return [y, *torch.autograd.grad(y, list(leaves.values()), gy.to(y.dtype))]

    got = run()
    monkeypatch.setattr(t_bert, "attn_softmax", _unfused_softmax)
    monkeypatch.setattr(t_bert, "add_layer_norm", _unfused_add_layer_norm)
    want = run()
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    # Dropout is on: another part of the same batch drops other elements.
    monkeypatch.undo()
    part = t_bert.Part(rows=(0, 12))
    assert not torch.equal(run()[0], got[0])
