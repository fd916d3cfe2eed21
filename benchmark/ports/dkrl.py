"""BLP with the DKRL encoder over a word table in the port."""

from __future__ import annotations

from benchmark.inputs import nest
from blp_tpu_torch.models import blp


def model_config(cfg: dict) -> blp.ModelConfig:
    head = cfg["blp"]
    if cfg["training"]["precision"] != "fp32":
        raise ValueError("the port's DKRL runs in float32")
    return blp.ModelConfig(
        model=cfg["model"], rel_model=head["rel_model"], loss_fn=head["loss_fn"],
        dim=head["dim"], num_relations=head["num_relations"],
        regularizer=head["regularizer"], emb_dim=cfg["word_dim"],
        vocab_size=cfg["vocab_rows"])


def params(weights: dict) -> dict:
    return nest(weights)
