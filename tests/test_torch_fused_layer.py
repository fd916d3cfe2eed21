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
