"""The port's BERT encoder (blp_tpu_torch/models/bert.py) against the JAX
package's bert_encode on the same weights (params_from_jax) and inputs.

fp32: hidden states within atol 1e-5 (tiny config) and 1e-4 (one
BERT-base-shaped layer) — the same fp32 math, summed in another order. bf16
fast path: within 1e-2 of the fp32 encode after L2 normalisation (the TPU
package's own bf16 noise class is 3.4e-3 to 4.6e-3 on normalized
embeddings)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.models import bert as j_bert
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models.blp import params_from_jax

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64)
BASE_LAYER = dict(vocab_size=128, hidden_size=768, num_layers=1, num_heads=12,
                  intermediate_size=3072, max_position_embeddings=64)


def _configs(widths, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "dtype" in kw:
        jkw["compute_dtype"] = {"f32": jnp.float32, "bf16": jnp.bfloat16}[kw["dtype"]]
        tkw["compute_dtype"] = {"f32": torch.float32, "bf16": torch.bfloat16}[kw["dtype"]]
        del jkw["dtype"], tkw["dtype"]
    return j_bert.BertConfig(**widths, **jkw), t_bert.BertConfig(**widths, **tkw)


def _inputs(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.float32)
    return ids, mask


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, j_bert.init_bert_params(jax.random.key(seed), jcfg))


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
@pytest.mark.parametrize("seq_pack", [1, "auto"])
def test_fp32_hidden_states_tiny(layout, seq_pack):
    jcfg, tcfg = _configs(TINY, seq_pack=seq_pack)
    jp = _jax_params(jcfg)
    if layout == "unstacked":
        jp = j_bert.unstack_layers(jp)
    ids, mask = _inputs(8, 16, 128, 1)
    want = np.asarray(j_bert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = t_bert.bert_encode(params_from_jax(jp), torch.from_numpy(ids),
                             torch.from_numpy(mask), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_fp32_hidden_states_bert_base_layer():
    jcfg, tcfg = _configs(BASE_LAYER)
    jp = _jax_params(jcfg)
    ids, mask = _inputs(4, 32, 128, 2)
    want = np.asarray(j_bert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = t_bert.bert_encode(params_from_jax(jp), torch.from_numpy(ids),
                             torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _normalized(x):
    x = np.asarray(x, np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_fast_path_within_noise_of_fp32(fused):
    jcfg, tcfg = _configs(TINY, dtype="bf16", fused_attention=fused)
    _, t32 = _configs(TINY)
    jp = _jax_params(jcfg, seed=3)
    tp = params_from_jax(jp)
    ids, mask = _inputs(8, 16, 128, 4)
    fast = t_bert.bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    assert fast.dtype == torch.bfloat16
    exact = t_bert.bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), t32)
    diff = np.abs(_normalized(fast.float().numpy()) - _normalized(exact.numpy()))
    assert diff.max() <= 1e-2
    # And the same class against the JAX package's own bf16 fast path.
    jfast = j_bert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    diff = np.abs(_normalized(fast.float().numpy()) - _normalized(jfast))
    assert diff.max() <= 1e-2


def test_bf16_exact_layer_within_noise():
    """bf16 with fast_inference off runs the exact layer's mixed-precision
    branch."""
    jcfg, tcfg = _configs(TINY, dtype="bf16", fast_inference=False)
    jp = _jax_params(jcfg, seed=5)
    ids, mask = _inputs(8, 16, 128, 6)
    want = j_bert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = t_bert.bert_encode(params_from_jax(jp), torch.from_numpy(ids),
                             torch.from_numpy(mask), tcfg)
    diff = np.abs(_normalized(got.float().numpy()) - _normalized(want))
    assert diff.max() <= 1e-2


def test_poly_gelu_matches_jax():
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    want = np.asarray(j_bert.poly_gelu(jnp.asarray(x)))
    got = t_bert.poly_gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_training_mode_raises():
    _, tcfg = _configs(TINY)
    jp = _jax_params(j_bert.BertConfig(**TINY))
    with pytest.raises(NotImplementedError):
        t_bert.bert_encode(params_from_jax(jp), torch.ones((4, 8), dtype=torch.long),
                           None, tcfg, deterministic=False)


def test_params_from_hf_state_dict_matches_jax():
    cfg_j, cfg_t = _configs(TINY)
    rng = np.random.default_rng(7)
    H, I = TINY["hidden_size"], TINY["intermediate_size"]
    sd = {
        "embeddings.word_embeddings.weight": (128, H),
        "embeddings.position_embeddings.weight": (64, H),
        "embeddings.token_type_embeddings.weight": (2, H),
        "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,),
        "pooler.dense.weight": (H, H), "pooler.dense.bias": (H,),
    }
    for i in range(TINY["num_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (H, H)),
                            ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)),
                            ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (I, H)),
                            ("output.dense", (H, I))):
            sd[p + name + ".weight"] = shape
            sd[p + name + ".bias"] = (shape[0],)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = (H,)
            sd[p + ln + ".bias"] = (H,)
    sd = {("bert." + k if i % 2 else k): rng.standard_normal(s).astype(np.float32)
          for i, (k, s) in enumerate(sd.items())}
    want = jax.tree.map(np.asarray, j_bert.params_from_hf_state_dict(sd, cfg_j))
    got = t_bert.params_from_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg_t)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    # The converted weights encode identically to the JAX conversion.
    ids, mask = _inputs(4, 8, 128, 8)
    np.testing.assert_allclose(
        t_bert.bert_encode(got, torch.from_numpy(ids), torch.from_numpy(mask),
                           cfg_t).numpy(),
        np.asarray(j_bert.bert_encode(j_bert.params_from_hf_state_dict(sd, cfg_j),
                                      jnp.asarray(ids), jnp.asarray(mask), cfg_j)),
        atol=1e-5, rtol=0)


def test_unstack_restack_roundtrip():
    jp = _jax_params(j_bert.BertConfig(**TINY))
    tp = params_from_jax(jp)
    back = t_bert.restack_layers(t_bert.unstack_layers(tp))
    for k, v in tp["layers"].items():
        assert torch.equal(back["layers"][k], v)
    assert t_bert.unstack_layers(t_bert.unstack_layers(tp))["layers"][1]["q_w"].shape == (32, 32)
    assert dataclasses.replace(t_bert.BertConfig.tiny(), seq_pack=1).seq_pack == 1
