"""BLP with a BERT encoder in the port: `blp.ModelConfig` with a
`bert.BertConfig`, as the port's `train.make_model_config` builds it from
a launcher's keys."""

from __future__ import annotations

import torch

from benchmark.inputs import nest
from blp_tpu_torch.models import bert, blp

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def model_config(cfg: dict) -> blp.ModelConfig:
    tr, inf, head = cfg["training"], cfg["inference"], cfg["blp"]
    encoder = bert.BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"], layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        initializer_range=cfg["initializer_range"],
        dropout_bits=tr["dropout_bits"], compute_dtype=DTYPES[tr["precision"]],
        remat=tr["remat"], fast_train=tr["fast_train"],
        fused_attention=inf["fused_attention"])
    return blp.ModelConfig(
        model="blp", rel_model=head["rel_model"], loss_fn=head["loss_fn"],
        dim=head["dim"], num_relations=head["num_relations"],
        regularizer=head["regularizer"], encoder=encoder)


def params(weights: dict) -> dict:
    """The port's parameter tree (layers stacked) over the weights, no copy."""
    return nest(weights)
