"""The port's reference-checkpoint converter
(blp_tpu_torch/tools/convert_reference_checkpoint.py) against the JAX
package's tools/convert_reference_checkpoint.py: reference-shaped state
dicts (the key layout of dfdazac/blp's model.state_dict(), built in torch
without transformers) convert to leaves equal bit for bit, for every layout,
with and without the `module.` prefix; and the port's CLI writes a file
that both packages load."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from blp_tpu import checkpoint as j_ckpt
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch.tools import convert_reference_checkpoint as t_conv

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import convert_reference_checkpoint as j_conv  # noqa: E402

H, LAYERS, FFN, VOCAB, POS, DIM, RELS = 64, 2, 96, 50, 40, 16, 5


def hf_bert_state_dict(g: torch.Generator, hidden=H, layers=LAYERS, ffn=FFN,
                       vocab=VOCAB, positions=POS) -> dict:
    """transformers.BertModel.state_dict()'s keys and shapes, random."""
    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"embeddings.word_embeddings.weight": r(vocab, hidden),
          "embeddings.position_embeddings.weight": r(positions, hidden),
          "embeddings.token_type_embeddings.weight": r(2, hidden),
          "embeddings.LayerNorm.weight": r(hidden),
          "embeddings.LayerNorm.bias": r(hidden),
          "pooler.dense.weight": r(hidden, hidden),
          "pooler.dense.bias": r(hidden)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[f"{p}attention.self.{name}.weight"] = r(hidden, hidden)
            sd[f"{p}attention.self.{name}.bias"] = r(hidden)
        sd[f"{p}attention.output.dense.weight"] = r(hidden, hidden)
        sd[f"{p}attention.output.dense.bias"] = r(hidden)
        sd[f"{p}attention.output.LayerNorm.weight"] = r(hidden)
        sd[f"{p}attention.output.LayerNorm.bias"] = r(hidden)
        sd[f"{p}intermediate.dense.weight"] = r(ffn, hidden)
        sd[f"{p}intermediate.dense.bias"] = r(ffn)
        sd[f"{p}output.dense.weight"] = r(hidden, ffn)
        sd[f"{p}output.dense.bias"] = r(hidden)
        sd[f"{p}output.LayerNorm.weight"] = r(hidden)
        sd[f"{p}output.LayerNorm.bias"] = r(hidden)
    return sd


def reference_state_dict(model: str, seed: int = 0, prefix: str = "") -> dict:
    """A reference model's state dict (reference models.py), random."""
    g = torch.Generator().manual_seed(seed)
    sd = {"rel_emb.weight": torch.randn((RELS, DIM), generator=g)}
    if model == "blp":
        sd["enc_linear.weight"] = torch.randn((DIM, H), generator=g)
        sd.update({f"encoder.{k}": v for k, v in hf_bert_state_dict(g).items()})
    elif model == "transductive":
        sd["ent_emb.weight"] = torch.randn((30, DIM), generator=g)
    else:
        sd["embeddings.weight"] = torch.randn((VOCAB, 24), generator=g)
        if model.endswith("dkrl"):
            sd["conv1.weight"] = torch.randn((DIM, 24, 2), generator=g)
            sd["conv1.bias"] = torch.randn((DIM,), generator=g)
            sd["conv2.weight"] = torch.randn((DIM, DIM, 2), generator=g)
            sd["conv2.bias"] = torch.randn((DIM,), generator=g)
    return {prefix + k: v for k, v in sd.items()}


MODELS = ["blp", "bert-bow", "glove-bow", "bert-dkrl", "glove-dkrl",
          "transductive"]


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("model", MODELS)
def test_leaves_bit_equal_to_jax_converter(model, prefix):
    sd = reference_state_dict(model, seed=MODELS.index(model), prefix=prefix)
    want = j_conv.convert_state_dict(sd, model)
    got = t_conv.convert_state_dict(sd, model)
    assert got.keys() == want.keys()
    w_leaves, g_leaves = jax.tree.leaves(want), t_ckpt.tree_leaves(got)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cli_writes_a_file_both_packages_load(tmp_path, capsys):
    sd = reference_state_dict("blp", prefix="module.")
    torch.save(sd, tmp_path / "model.pt")
    out = str(tmp_path / "model-blp.npz")
    t_conv.main(["--model", "blp", "--input", str(tmp_path / "model.pt"),
                 "--output", out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["top_level"] == ["bert", "proj", "rel_emb"]
    want = j_conv.convert_state_dict(sd, "blp")
    j_tree, j_meta = j_ckpt.load_pytree(out)
    t_tree, t_meta = t_ckpt.load_pytree(out)
    assert j_meta == t_meta and t_meta["model"] == "blp"
    for w, j, t in zip(jax.tree.leaves(want), jax.tree.leaves(j_tree),
                       t_ckpt.tree_leaves(t_tree)):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(w))
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_rejects_unknown_model_and_foreign_file(tmp_path):
    with pytest.raises(ValueError, match="unknown model"):
        t_conv.convert_state_dict(reference_state_dict("bert-bow"), "nope")
    torch.save({"weight": torch.zeros(2)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a reference BLP state dict"):
        t_conv.main(["--model", "blp", "--input", str(tmp_path / "other.pt"),
                     "--output", str(tmp_path / "x.npz")])
