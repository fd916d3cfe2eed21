"""F1 (bias + activation) and F2 (residual + LayerNorm) of the port's BERT
layer (blp_tpu_torch/ops/fused_layer.py) on the CPU, where they run their
plain versions.

- The plain versions against the JAX package's functions on the same numpy
  inputs, forward and through jax.vjp: F1 against `_dense` (on an identity
  weight, so the product is exact and the comparison is F1's alone) followed
  by no activation, `jax.nn.gelu(approximate=False)` evaluated in f32 from
  the rounded pre-activation, or `poly_gelu`; F2 against `_layer_norm` of
  x + r. f32: atol 1e-6; bf16: outputs and row gradients within one bf16
  ulp; db, dscale and dbias (sums over rows, in another order) within rtol
  1e-4. For erf, beyond x = -4, F.gelu (1 + erf(x/sqrt2)) has lost its f32
  digits where jax.nn.gelu (erfc) keeps them: there the bf16 outputs and
  dh are held to an absolute 1e-6 instead.
- The autograd.Functions' outputs and gradients equal torch.autograd of the
  unfused chain bit for bit (their CPU backwards re-run it on what they
  saved).
- The memory fix: one BERT-base-width bf16 training layer saves at most 40
  KB a token, and no f32 tensor of the FFN or hidden width, with fast_train
  on and off (~190 and ~49 KB before).
- F1's head-major layout (q, k and v as (B, nh, S, hd)): the plain version
  against the JAX package's head-major projection (blp_tpu/models/bert.py
  :411-415, its einsum "bsh,hnd->bnsd" plus the bias, on an identity
  weight) and its jax.vjp, with the tolerances above; the Function bit-equal
  to the plain version and its autograd VJP, for a contiguous cotangent and
  for k's, strided as q k^T's backward leaves it; the cotangent layouts the
  kernel path reads; F1's row chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.models import bert as j_bert
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.ops import fused_layer

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
EPS = 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy()


def _j(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_ulp(got, want, atol=0.0):
    """Every element of got within one bf16 ulp of want, or within atol
    (f32 arrays of bf16 values)."""
    ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)
    return bool(np.all(np.abs(got - want) <= np.maximum(ulp, atol)))


def _assert_close(got, want, dtype, atol=0.0):
    if dtype == "bf16":
        assert _within_ulp(got, want, atol), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _assert_sum_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _f1_inputs(rows, w, dtype, seed):
    rng = np.random.default_rng(seed)
    h = (2.5 * rng.standard_normal((rows, w))).astype(np.float32)
    h = np.asarray(jnp.asarray(h, J_DT[dtype]).astype(jnp.float32))  # dtype's values
    b = (0.5 * rng.standard_normal(w)).astype(np.float32)
    g = rng.standard_normal((rows, w)).astype(np.float32)
    g = np.asarray(jnp.asarray(g, J_DT[dtype]).astype(jnp.float32))
    return h, b, g


def _jax_f1(act, dtype):
    def f(h, b):
        pre = j_bert._dense(h.astype(J_DT[dtype]), jnp.eye(h.shape[-1]), b,
                            J_DT[dtype], J_DT[dtype])
        if act == "erf":
            return jax.nn.gelu(pre.astype(jnp.float32),
                               approximate=False).astype(pre.dtype)
        if act == "poly":
            return j_bert.poly_gelu(pre)
        return pre
    return f


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["none", "erf", "poly"])
def test_bias_act_plain_matches_jax(act, dtype):
    h, b, g = _f1_inputs(96, 64, dtype, seed=1)
    want, vjp = jax.vjp(_jax_f1(act, dtype), jnp.asarray(h, J_DT[dtype]),
                        jnp.asarray(b))
    dh_want, db_want = vjp(jnp.asarray(g, J_DT[dtype]))
    th = torch.from_numpy(h).to(T_DT[dtype]).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = fused_layer.bias_act_plain(th, tb, act, T_DT[dtype])
    assert got.dtype == T_DT[dtype]
    dh, db = torch.autograd.grad(got, (th, tb), torch.from_numpy(g).to(T_DT[dtype]))
    tail = 1e-6 if act == "erf" else 0.0
    _assert_close(_np(got), _j(want), dtype, tail)
    _assert_close(_np(dh), _j(dh_want), dtype, tail)
    _assert_sum_close(_np(db), _j(db_want))


def _f2_inputs(rows, dtype, seed):
    rng = np.random.default_rng(seed)

    def rounded(a):
        return np.asarray(jnp.asarray(a.astype(np.float32), J_DT[dtype])
                          .astype(jnp.float32))
    x = rounded(1.0 + rng.standard_normal((rows, 64)))
    r = rounded(0.5 * rng.standard_normal((rows, 64)))
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rounded(rng.standard_normal((rows, 64)))
    return x, r, scale, bias, g


@pytest.mark.parametrize("with_r", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_add_layer_norm_plain_matches_jax(dtype, with_r):
    x, r, scale, bias, g = _f2_inputs(96, dtype, seed=2)
    jd, td = J_DT[dtype], T_DT[dtype]
    out = None if dtype == "f32" else jd

    def f(x, r, scale, bias):
        return j_bert._layer_norm(x + r if with_r else x, scale, bias, EPS,
                                  out_dtype=out)

    want, vjp = jax.vjp(f, jnp.asarray(x, jd), jnp.asarray(r, jd),
                        jnp.asarray(scale), jnp.asarray(bias))
    dx_want, dr_want, ds_want, db_want = vjp(jnp.asarray(g, jd))
    ins = [torch.from_numpy(a).to(t).requires_grad_() for a, t in
           ((x, td), (r, td), (scale, torch.float32), (bias, torch.float32))]
    got = fused_layer.add_layer_norm_plain(ins[0], ins[1] if with_r else None,
                                           ins[2], ins[3], EPS,
                                           None if dtype == "f32" else td)
    grads = torch.autograd.grad(got, ins if with_r else [ins[0], *ins[2:]],
                                torch.from_numpy(g).to(got.dtype))
    _assert_close(_np(got), _j(want), dtype)
    _assert_close(_np(grads[0]), _j(dx_want), dtype)
    if with_r:
        _assert_close(_np(grads[1]), _j(dr_want), dtype)
    _assert_sum_close(_np(grads[-2]), _j(ds_want))
    _assert_sum_close(_np(grads[-1]), _j(db_want))


def _leaves(*arrays, dtypes):
    return [torch.from_numpy(a).to(d).requires_grad_() for a, d in zip(arrays, dtypes)]


@pytest.mark.parametrize("act", ["none", "erf", "poly"])
@pytest.mark.parametrize("h_dt,out_dt,bias", [
    ("bf16", "bf16", True), ("f32", "f32", True), ("f32", "bf16", True),
    ("bf16", "f32", True), ("bf16", "bf16", False)])
def test_bias_act_function_equals_autograd_of_the_unfused_chain(act, h_dt, out_dt,
                                                                bias):
    h, b, g = _f1_inputs(3 * 37, 40, "bf16", seed=3)
    gy = torch.from_numpy(g).to(T_DT[out_dt])
    got, want = [], []
    for fn, dest in ((fused_layer.bias_act, got), (fused_layer.bias_act_plain, want)):
        th, tb = _leaves(h.reshape(3, 37, 40), b, dtypes=(T_DT[h_dt], torch.float32))
        y = fn(th, tb if bias else None, act, T_DT[out_dt])
        dest.append(y)
        dest.extend(torch.autograd.grad(y, (th, tb) if bias else (th,),
                                        gy.reshape(3, 37, 40)))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("x_dt,r_dt,out_dt", [
    ("bf16", "bf16", "bf16"), ("f32", "f32", None), ("bf16", "f32", "bf16"),
    ("f32", None, "bf16"), ("f32", None, None)])
def test_add_layer_norm_function_equals_autograd_of_the_unfused_chain(x_dt, r_dt,
                                                                      out_dt):
    x, r, scale, bias, g = _f2_inputs(2 * 45, "bf16", seed=4)
    od = None if out_dt is None else T_DT[out_dt]
    gy = torch.from_numpy(g).reshape(2, 45, 64).to(od or torch.float32)
    got, want = [], []
    for fn, dest in ((fused_layer.add_layer_norm, got),
                     (fused_layer.add_layer_norm_plain, want)):
        ins = _leaves(x.reshape(2, 45, 64), r.reshape(2, 45, 64), scale, bias,
                      dtypes=(T_DT[x_dt], T_DT[r_dt or "f32"], torch.float32,
                              torch.float32))
        rr = ins[1] if r_dt else None
        y = fn(ins[0], rr, ins[2], ins[3], EPS, od)
        dest.append(y)
        dest.extend(torch.autograd.grad(
            y, ins if r_dt else [ins[0], *ins[2:]], gy))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def _saved(fn):
    """The tensors autograd saves while fn runs."""
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


def test_functions_save_only_the_small_set():
    h = torch.randn(16, 24, dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn(24, requires_grad=True)
    assert _saved(lambda: fused_layer.bias_act(h, b, "none", torch.bfloat16)) == []
    saved = _saved(lambda: fused_layer.bias_act(h, b, "poly", torch.bfloat16))
    assert [t.data_ptr() for t in saved] == [h.data_ptr(), b.data_ptr()]
    x = torch.randn(16, 24, dtype=torch.bfloat16, requires_grad=True)
    scale, bias = torch.ones(24, requires_grad=True), torch.zeros(24, requires_grad=True)
    saved = _saved(lambda: fused_layer.add_layer_norm(x, h, scale, bias, EPS,
                                                      torch.bfloat16))
    assert [(t.dtype, tuple(t.shape)) for t in saved[:3]] == [
        (torch.bfloat16, (16, 24)), (torch.float32, (16, 1)), (torch.float32, (16, 1))]
    assert [t.data_ptr() for t in saved[3:]] == [scale.data_ptr(), bias.data_ptr()]


def test_bias_act_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="act must be one of"):
        fused_layer.bias_act(torch.zeros(2, 8), None, "relu")


@pytest.mark.parametrize("fast_train", [True, False])
def test_bert_base_training_layer_saves_at_most_40_kb_a_token(fast_train):
    """One BERT-base-width bf16 training layer (dropout on, 8-bit masks) at 4
    x 128 tokens: the bytes of the distinct storages autograd saves, the
    layer's weights (and their bf16 casts) left out."""
    H, I, B, S = 768, 3072, 4, 128
    T = B * S
    cfg = t_bert.BertConfig(num_layers=1, compute_dtype=torch.bfloat16,
                            fast_train=fast_train, dropout_bits=8)
    params = t_bert.unstack_layers(t_bert.init_bert_params(
        cfg, torch.Generator().manual_seed(0)))
    lp = {k: v.requires_grad_() for k, v in params["layers"][0].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, H))
                         .astype(np.float32)).to(torch.bfloat16).requires_grad_()
    weights = {(H, H), (H, I), (I, H)}
    storages, wide_f32 = {}, []

    def pack(t):
        if tuple(t.shape) not in weights:
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            if t.dtype == torch.float32 and t.numel() in (T * H, T * I):
                wide_f32.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = t_bert._encoder_layer(cfg, x, torch.zeros(B, 1, 1, S), lp,
                                  seeds=(1, 2, 3), rate=0.1)
    assert y.shape == (B, S, H) and y.dtype == torch.bfloat16
    per_token = sum(storages.values()) / T
    assert per_token <= 40e3, per_token
    assert wide_f32 == []


@pytest.mark.parametrize("fast_train", [True, False])
def test_bert_base_training_layer_saves_at_most_32_kb_a_token(fast_train):
    """The layer above since F3 (ops/attn_softmax.py) saves the bf16 logits
    in place of the f32 softmax output: at most 32 KB a token (~30.9), and
    no f32 tensor of the attention probabilities' (B, heads, S, S) shape."""
    H, B, S, nh = 768, 4, 128, 12
    cfg = t_bert.BertConfig(num_layers=1, compute_dtype=torch.bfloat16,
                            fast_train=fast_train, dropout_bits=8)
    params = t_bert.unstack_layers(t_bert.init_bert_params(
        cfg, torch.Generator().manual_seed(0)))
    lp = {k: v.requires_grad_() for k, v in params["layers"][0].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, H))
                         .astype(np.float32)).to(torch.bfloat16).requires_grad_()
    weights = {(H, H), (H, cfg.intermediate_size), (cfg.intermediate_size, H)}
    storages, attn_f32 = {}, []

    def pack(t):
        if tuple(t.shape) not in weights:
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            if t.dtype == torch.float32 and tuple(t.shape) == (B, nh, S, S):
                attn_f32.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t_bert._encoder_layer(cfg, x, torch.zeros(B, 1, 1, S), lp,
                              seeds=(1, 2, 3), rate=0.1)
    assert sum(storages.values()) / (B * S) <= 32e3
    assert attn_f32 == []


def _jax_head_major(dtype, nh, hd):
    """The TPU package's mixed-precision q/k/v projection (bert.py:411-415)
    on an identity weight, so the product is exact and the comparison is
    F1's bias add and layout alone."""
    def proj(x, b):
        H = x.shape[-1]
        out = jnp.einsum("bsh,hnd->bnsd", x.astype(J_DT[dtype]),
                         jnp.eye(H, dtype=J_DT[dtype]).reshape(H, nh, hd),
                         preferred_element_type=jnp.float32)
        return (out + b.reshape(nh, 1, hd)).astype(J_DT[dtype])
    return proj


#: (B, S, heads, head width): BERT's 64-wide heads, a ragged S, one row.
HEAD_SHAPES = [(2, 8, 4, 8), (3, 5, 2, 16), (2, 16, 3, 64), (1, 1, 2, 8)]


@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bias_act_head_major_plain_matches_jax(dtype, shape):
    B, S, nh, hd = shape
    h, b, _ = _f1_inputs(B * S, nh * hd, dtype, seed=6)
    h = h.reshape(B, S, nh * hd)
    g = np.random.default_rng(7).standard_normal((B, nh, S, hd)).astype(np.float32)
    g = np.asarray(jnp.asarray(g, J_DT[dtype]).astype(jnp.float32))
    want, vjp = jax.vjp(_jax_head_major(dtype, nh, hd), jnp.asarray(h, J_DT[dtype]),
                        jnp.asarray(b))
    dh_want, db_want = vjp(jnp.asarray(g, J_DT[dtype]))
    th = torch.from_numpy(h).to(T_DT[dtype]).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = fused_layer.bias_act_plain(th, tb, "none", T_DT[dtype], head_dim=hd)
    assert got.shape == (B, nh, S, hd) and got.is_contiguous()
    dh, db = torch.autograd.grad(got, (th, tb), torch.from_numpy(g).to(T_DT[dtype]))
    _assert_close(_np(got), _j(want), dtype)
    _assert_close(_np(dh), _j(dh_want), dtype)
    _assert_sum_close(_np(db), _j(db_want))


def _k_layout(g):
    """g (B, nh, S, hd) held as (B, nh, hd, S): k's cotangent after q k^T's
    backward."""
    return g.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("cotangent", ["contiguous", "k"])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("h_dt,out_dt", [("bf16", "bf16"), ("f32", "bf16"),
                                         ("f32", "f32")])
def test_bias_act_head_major_function_equals_plain(h_dt, out_dt, shape, cotangent):
    B, S, nh, hd = shape
    h, b, _ = _f1_inputs(B * S, nh * hd, "bf16", seed=8)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, nh, S, hd)).astype(np.float32)).to(T_DT[out_dt])
    if cotangent == "k":
        g = _k_layout(g)
    got, want = [], []
    for fn, dest in ((fused_layer.bias_act, got), (fused_layer.bias_act_plain, want)):
        th, tb = _leaves(h.reshape(B, S, nh * hd), b, dtypes=(T_DT[h_dt], torch.float32))
        y = fn(th, tb, "none", T_DT[out_dt], head_dim=hd)
        dest.append(y)
        dest.extend(torch.autograd.grad(y, (th, tb), g))
    assert got[0].shape == (B, nh, S, hd) and got[0].is_contiguous()
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("shape,make,layout", [
    ((2, 3, 16, 8), lambda g: g, "heads"),
    ((2, 3, 16, 8), _k_layout, "heads_t"),
    ((2, 3, 12, 8), _k_layout, "heads"),          # S not a multiple of 8
    ((2, 3, 16, 8), lambda g: g.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
     "heads")])
def test_head_major_cotangent_layouts(shape, make, layout):
    """The layout the kernel path reads a head-major cotangent in: its own,
    k's (B, nh, hd, S) when S is a multiple of 8, and a contiguous copy of
    any other."""
    g = make(torch.randn(shape))
    got, g2 = fused_layer._g_layout(g, shape[-1])
    assert got == layout and torch.equal(g2, g)
    assert (g2 is g) == (layout != "heads" or g.is_contiguous())


@pytest.mark.parametrize("rows", [1, 63, 64, 997, 16_384, 20_000, 131_072, 786_432])
def test_f1_chunks_are_whole_groups_within_the_chunk_limit(rows):
    """F1's backward row chunks: whole 64-row groups (k's 8-row transpose
    never crosses one), at most F1_MAX_CHUNKS of them, and the smallest
    such."""
    limit = fused_layer.F1_MAX_CHUNKS
    chunk = fused_layer.f1_chunk_rows(rows)
    assert chunk % fused_layer.F1_CHUNK_ROWS == 0
    assert -(-rows // chunk) <= limit
    assert (chunk == fused_layer.F1_CHUNK_ROWS
            or -(-rows // (chunk - fused_layer.F1_CHUNK_ROWS)) > limit)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_major_projection_equals_the_transpose_of_dense(dtype):
    """models/bert.py `_head_major` (F1 writing q head-major) equals the row
    projection `_dense` reshaped and permuted, forward and backward."""
    B, S, nh, hd = 2, 8, 4, 8
    rng = np.random.default_rng(10)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, nh * hd), (nh * hd, nh * hd)))
    b = torch.from_numpy(rng.standard_normal(nh * hd).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, nh, S, hd)).astype(np.float32))
    res = []
    for fn in (lambda xx, ww, bb: t_bert._head_major(xx, ww, bb, hd, T_DT[dtype]),
               lambda xx, ww, bb: t_bert._dense(xx, ww, bb, T_DT[dtype], T_DT[dtype])
               .reshape(B, S, nh, hd).permute(0, 2, 1, 3)):
        ins = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*ins)
        res.append([y, *torch.autograd.grad(y, ins, g.to(y.dtype))])
    assert res[0][0].is_contiguous()
    for a, w_ in zip(*res):
        assert torch.equal(a, w_)
