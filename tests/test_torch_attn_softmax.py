"""F3, the attention softmax chain of the port's BERT layer
(blp_tpu_torch/ops/attn_softmax.py), on the CPU, where it runs its plain
version.

- `attn_softmax_plain` against the JAX package's chain on the same numpy
  logits: the training layer's `jax.nn.softmax(l / sqrt(hd) + bias)` cast to
  the output dtype (blp_tpu/models/bert.py:430-438), forward and through
  jax.vjp, and the inference layer's bf16-logits chain (:357-365), forward.
  f32: rtol 1e-5, atol 1e-7 (the two libraries' exp and sum orders); bf16
  outputs within one bf16 ulp; dl, which this chain rounds to bf16 where
  JAX keeps f32, within one bf16 ulp of JAX's or 1e-5 of its largest value
  (the backward's t - p * sum(t) cancels).
- The autograd.Function against the parent's op-by-op chain (the code the
  layer ran before F3, written out below with `_rng_dropout`), bit for bit,
  forward and gradient, in every dtype pair the layer uses, with 8-, 16- and
  32-bit dropout masks and none, with packed and unpacked bias, a dropout
  block, and a row whose keys are all masked; and whole BERT layers, bit for
  bit, with the parent chain patched in.
- The saved set is l alone, and more keys than the kernel holds raise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.ops import attn_softmax as f3

T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
HD = 16
SCALE = math.sqrt(HD)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bias(kind, b, s, rng):
    """The layer's additive bias: unpacked (B, 1, 1, S) from a key mask, or
    packed (B, 1, S, S) block-diagonal over two segments; row 0's keys all
    masked in both."""
    keys = (rng.random((b, s)) > 0.3).astype(np.float32)
    keys[0] = 0.0
    if kind == "unpacked":
        return ((1.0 - keys) * -10000.0)[:, None, None, :]
    seg = np.arange(s) // (s // 2)
    visible = (seg[:, None] == seg[None, :])[None] & (keys[:, None, :] > 0)
    return np.where(visible, 0.0, -10000.0).astype(np.float32)[:, None]


def _inputs(kind, l_dt, out_dt, seed, b=3, nh=4, s=24):
    rng = np.random.default_rng(seed)
    l = (6.0 * rng.standard_normal((b, nh, s, s))).astype(np.float32)
    l = np.asarray(jnp.asarray(l, J_DT[l_dt]).astype(jnp.float32))   # l_dt's values
    g = rng.standard_normal((b, nh, s, s)).astype(np.float32)
    g = np.asarray(jnp.asarray(g, J_DT[out_dt]).astype(jnp.float32))
    return l, _bias(kind, b, s, rng), g


def _within_ulp(got, want, atol=0.0):
    ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)
    return bool(np.all(np.abs(got - want) <= np.maximum(ulp, atol)))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
@pytest.mark.parametrize("l_dt,out_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                         ("f32", "f32")])
def test_plain_matches_jax_training_chain(l_dt, out_dt, kind):
    l, bias, g = _inputs(kind, l_dt, out_dt, seed=1)

    def jax_chain(logits):
        return jax.nn.softmax(logits / SCALE + bias, axis=-1).astype(J_DT[out_dt])

    want, vjp = jax.vjp(jax_chain, jnp.asarray(l))
    dl_want, = vjp(jnp.asarray(g, J_DT[out_dt]))
    tl = torch.from_numpy(l).to(T_DT[l_dt]).requires_grad_()
    got = f3.attn_softmax_plain(tl, torch.from_numpy(bias), SCALE, T_DT[out_dt])
    dl, = torch.autograd.grad(got, tl, torch.from_numpy(g).to(T_DT[out_dt]))
    want, dl_want = np.asarray(want, np.float32), np.asarray(dl_want, np.float32)
    if out_dt == "bf16":
        assert _within_ulp(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-7)
    top = np.abs(dl_want).max()
    if l_dt == "bf16":
        assert _within_ulp(_np(dl), dl_want, 1e-5 * top)
    else:
        np.testing.assert_allclose(_np(dl), dl_want, rtol=1e-5, atol=1e-5 * top)
    assert np.isfinite(_np(got)[0]).all()


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_plain_matches_jax_inference_chain(kind):
    l, bias, _ = _inputs(kind, "bf16", "bf16", seed=2)
    logits = (jnp.asarray(l) / SCALE + bias).astype(jnp.bfloat16)
    m = jnp.max(logits, axis=-1, keepdims=True).astype(jnp.float32)
    e = jnp.exp(logits.astype(jnp.float32) - m)
    want = (e / jnp.sum(e, axis=-1, keepdims=True)).astype(jnp.bfloat16)
    got = f3.attn_softmax_plain(torch.from_numpy(l).to(torch.bfloat16),
                                torch.from_numpy(bias), SCALE, torch.bfloat16,
                                round_logits=True)
    assert got.dtype == torch.bfloat16
    assert _within_ulp(_np(got), np.asarray(want, np.float32))


def _parent_chain(l, mask_bias, scale, out_dtype, round_logits=False,
                  dropout=None):
    """The layer's attention chain before F3 (models/bert.py, op by op)."""
    if round_logits:
        logits = (l.to(torch.float32) / scale + mask_bias).to(torch.bfloat16)
        m = logits.amax(dim=-1, keepdim=True).to(torch.float32)
        e = torch.exp(logits.to(torch.float32) - m)
        return (e / e.sum(dim=-1, keepdim=True)).to(out_dtype)
    probs = torch.softmax(l.to(torch.float32) / scale + mask_bias, dim=-1)
    if out_dtype != torch.float32:
        probs = probs.to(out_dtype)
    if dropout is not None:
        probs = t_bert._rng_dropout(probs, *dropout)
    return probs


def _y_and_grad(fn, l, bias, g, out_dt, dropout):
    tl = l.clone().requires_grad_()
    y = fn(tl, bias, SCALE, out_dt, dropout=dropout)
    return (y, *torch.autograd.grad(y, tl, g))


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
@pytest.mark.parametrize("nbits", [8, 16, 32, None])
@pytest.mark.parametrize("l_dt,out_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                         ("f32", "f32")])
def test_function_equals_the_parent_chain(l_dt, out_dt, nbits, kind):
    l, bias, g = _inputs(kind, l_dt, out_dt, seed=3)
    l = torch.from_numpy(l).to(T_DT[l_dt])
    bias = torch.from_numpy(bias)
    g = torch.from_numpy(g).to(T_DT[out_dt])
    dropout = None if nbits is None else (1234, 0.3, nbits, None)
    got = _y_and_grad(f3.attn_softmax, l, bias, g, T_DT[out_dt], dropout)
    want = _y_and_grad(_parent_chain, l, bias, g, T_DT[out_dt], dropout)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert torch.isfinite(got[0][0]).all() and torch.isfinite(got[1][0]).all()


def test_function_in_a_dropout_block_equals_the_parent_chain():
    """Rows 1-2 and heads 2-3 of a (4, 6, S, S) site, as a data- and
    tensor-parallel rank takes its block of the one-device mask."""
    l, bias, g = _inputs("packed", "bf16", "bf16", seed=4, b=2, nh=2)
    block = ((4, 6, 24, 24), (1, 2, 0, 0))
    args = (torch.from_numpy(l).to(torch.bfloat16), torch.from_numpy(bias),
            torch.from_numpy(g).to(torch.bfloat16), torch.bfloat16,
            (99, 0.1, 8, block))
    got = _y_and_grad(f3.attn_softmax, *args)
    want = _y_and_grad(_parent_chain, *args)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_inference_variant_equals_the_parent_chain(kind):
    l, bias, _ = _inputs(kind, "bf16", "bf16", seed=5)
    args = (torch.from_numpy(l).to(torch.bfloat16), torch.from_numpy(bias),
            SCALE, torch.bfloat16)
    with torch.no_grad():
        got = f3.attn_softmax(*args, round_logits=True)
        want = _parent_chain(*args, round_logits=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_saves_only_the_logits():
    l = torch.randn(2, 3, 8, 8, dtype=torch.bfloat16, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        f3.attn_softmax(l, torch.zeros(2, 1, 1, 8), 2.0, torch.bfloat16,
                        dropout=(7, 0.1, 8, None))
    assert len(saved) == 1 and saved[0] is l


def test_more_keys_than_the_kernel_holds_raise():
    l = torch.zeros(1, 1, 2, f3.MAX_SK + 1)
    with pytest.raises(ValueError, match=f"above {f3.MAX_SK}"):
        f3.attn_softmax(l, torch.zeros(1, 1, 1, f3.MAX_SK + 1), 8.0, torch.float32)
    f3.attn_softmax(l[..., :f3.MAX_SK], torch.zeros(1, 1, 1, f3.MAX_SK), 8.0,
                    torch.float32)


@pytest.mark.parametrize("dtype,kw", [
    ("f32", {}),
    ("bf16", {}),
    ("bf16", {"mixed_precision_train": False}),
    ("bf16", {"fast_train": True, "dropout_bits": 8, "remat": "dots"}),
    ("bf16", {"dropout_bits": 16, "remat": "names", "seq_pack": 1}),
    ("f32", {"remat": True, "seq_pack": 1}),
])
def test_layers_equal_the_parent_chain(monkeypatch, dtype, kw):
    """A 2-layer encoder's training pass (dropout on) with F3 and with the
    parent's op-by-op chain patched in: the same output and gradients, bit
    for bit."""
    cfg = t_bert.BertConfig.tiny(compute_dtype=T_DT[dtype], **kw)
    params = t_bert.init_bert_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 12)))
    mask = torch.from_numpy((np.arange(12)[None] < rng.integers(3, 13, (4, 1)))
                            .astype(np.float32))

    gy = torch.from_numpy(rng.standard_normal((4, 12, cfg.hidden_size))
                          .astype(np.float32))

    def run():
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params["layers"].items()}
        p = dict(params, layers=leaves)
        y = t_bert.bert_encode(p, ids, mask, cfg, deterministic=False,
                               dropout_seed=11)
        return [y, *torch.autograd.grad(y, list(leaves.values()), gy.to(y.dtype))]

    got = run()
    monkeypatch.setattr(t_bert, "attn_softmax", _parent_chain)
    want = run()
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


# -- the tile design's host-side choices (ops/attn_softmax.py) -------------------

#: A block's shared memory with three blocks on an SM (228 KB, 1 KB of each
#: block's reserved; the forward's launch bounds) and with two (the
#: backward's), and the layout of csrc/attn_softmax.cu `tile_smem_bytes`: the
#: mbarriers padded to 128 bytes, the ring of slabs, two bias slots of rows x
#: Sk f32.
THREE_A_SM = 228 * 1024 // 3 - 1024
TWO_A_SM = 228 * 1024 // 2 - 1024


def _tile_smem(rows, sk, slab_elem_bytes, stages):
    bars = ((2 * stages + 4) * 8 + 127) // 128 * 128
    return bars + stages * rows * sk * slab_elem_bytes + 2 * rows * sk * 4


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("l_dt,out_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                         ("f32", "f32")])
@pytest.mark.parametrize("sk", [8, 64, 72, 128, 200, 256])
def test_tile_plan_fits_three_blocks_an_sm(sk, l_dt, out_dt, backward):
    """Lanes a row (TILE_LANE_KEYS keys a lane), rows a tile (one row a
    lane: 8 warps of 32 lanes) and ring stages for every row length the tile
    design takes: at least two stages, at most TILE_MAX_STAGES, as many as
    fit TILE_BLOCK_SMEM, and the shared memory of three forward blocks (two
    backward ones) on one SM."""
    lanes, rows, stages = f3.tile_plan(sk, T_DT[l_dt], T_DT[out_dt], backward)
    keys = f3.TILE_LANE_KEYS
    assert lanes * keys >= sk and (lanes == 64 // keys or lanes * keys // 2 < sk)
    assert rows * lanes == 32 * f3.TILE_WARPS
    elem = T_DT[l_dt].itemsize + (T_DT[out_dt].itemsize if backward else 0)
    assert 2 <= stages <= f3.TILE_MAX_STAGES
    smem = _tile_smem(rows, sk, elem, stages)
    assert smem <= (TWO_A_SM if backward else THREE_A_SM)
    assert stages in (2, f3.TILE_MAX_STAGES) or (
        smem <= f3.TILE_BLOCK_SMEM < _tile_smem(rows, sk, elem, stages + 1))


def test_tile_plan_at_the_layers_shape():
    """Sk 128: 8 lanes a row (16 keys a lane), 32-row tiles; 4 slabs of bf16
    logits forward, 2 of l and g backward."""
    bf = torch.bfloat16
    assert f3.tile_plan(128, bf, bf, False) == (8, 32, 4)
    assert f3.tile_plan(128, bf, bf, True) == (8, 32, 2)
    assert f3.tile_plan(128, torch.float32, torch.float32, False) == (8, 32, 2)


def _aligned(shape, dtype=torch.bfloat16, offset=0):
    n = math.prod(shape)
    buf = torch.zeros(n + 16, dtype=dtype)
    skip = (-buf.data_ptr() // buf.element_size()) % (16 // buf.element_size())
    return buf[skip + offset:skip + offset + n].view(shape)


@pytest.mark.parametrize("case,want", [
    ("packed", "tile"), ("unpacked", "tile"), ("one head, head stride", "tile"),
    ("head stride", "row"), ("sk 100", "row"), ("sk 264", "row"),
    ("unaligned logits", "row"), ("bias key stride 2", "row"),
    ("bias query stride 130", "row"), ("sk 8", "tile"),
    ("rounded logits", "tile"), ("rounded logits with dropout", "row"),
])
def test_design_takes_the_tile_kernel_where_it_can(case, want):
    """The layer's biases, (B, 1, S, S) packed and (B, 1, 1, S), broadcast to
    l's shape, take the tile design at Sk 128; a bias with a head stride, Sk
    not a multiple of 8 or above TILE_MAX_SK, an unaligned pointer, a key
    stride other than 1 or a query stride that is not a multiple of 4 take
    the row design, and so do rounded logits (the inference variant) with
    dropout."""
    b, nh, sq, sk = 2, 3, 20, 128
    if case.startswith("sk "):
        sk = int(case[3:])
    if case.startswith("one head"):
        nh = 1
    l = _aligned((b, nh, sq, sk), offset=1 if case == "unaligned logits" else 0)
    if case == "unpacked":
        bias = _aligned((b, 1, 1, sk), torch.float32)
    elif "head stride" in case:
        bias = _aligned((b, nh, sq, sk), torch.float32)
    elif case == "bias key stride 2":
        bias = _aligned((b, 1, sq, 2 * sk), torch.float32)[..., ::2]
    elif case == "bias query stride 130":
        bias = _aligned((b, 1, sq, sk + 2), torch.float32)[..., :sk]
    else:
        bias = _aligned((b, 1, sq, sk), torch.float32)
    bias = bias.expand(l.shape)
    out = _aligned((b, nh, sq, sk))
    if case.startswith("rounded"):
        drop = (1, 0.1, 8, None) if case.endswith("dropout") else None
        assert f3.design(l, bias, out, round_logits=True, dropout=drop) == want
        return
    assert f3.design(l, bias, out) == want
    assert f3.design(l, bias, out, _aligned((b, nh, sq, sk))) == want
    if want == "tile":
        assert f3.design(l, bias, out, _aligned((b, nh, sq, sk), offset=3)) == "row"
