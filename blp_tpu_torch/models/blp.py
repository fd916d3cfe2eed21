"""Model assembly for inference: the BLP configuration, init and encode.

Port of blp_tpu/models/blp.py for the `blp` (BERT -> [CLS] -> bias-free
projection) and `transductive` (entity lookup table) models. Entity
embeddings are L2-normalized iff the relational model is TransE. Parameters
are plain dicts of tensors in the TPU package's layout; `params_from_jax`
turns that package's parameter tree (numpy leaves) into this one. The
bow/dkrl encoders and the training loss come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blp_tpu_torch.models import bert as bert_mod
from blp_tpu_torch.models import scoring
from blp_tpu_torch.utils import resolve_device

TEXT_MODELS = ("blp", "bert-bow", "bert-dkrl", "glove-bow", "glove-dkrl")
ALL_MODELS = TEXT_MODELS + ("transductive",)
#: Models this port can initialize and encode so far.
PORTED_MODELS = ("blp", "transductive")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model: str = "blp"
    rel_model: str = "transe"
    loss_fn: str = "margin"
    dim: int = 128
    num_relations: int = 1
    num_entities: int = 0          # transductive only
    regularizer: float = 0.0
    emb_dim: int = 300             # word-embedding width for bow/dkrl models
    vocab_size: int = 0            # word-vocab size for bow/dkrl models
    encoder: bert_mod.BertConfig | None = None  # for model == 'blp'
    sddmm_pallas: bool = False     # fused pos+neg scoring (training slice)

    def __post_init__(self):
        if self.model not in ALL_MODELS:
            raise ValueError(f"Unknown model {self.model!r}")
        scoring.get_score_fn(self.rel_model)
        scoring.get_loss_fn(self.loss_fn)
        if self.model == "blp" and self.encoder is None:
            object.__setattr__(self, "encoder", bert_mod.BertConfig())

    @property
    def normalize_embs(self) -> bool:
        return self.rel_model in scoring.NORMALIZED_REL_MODELS

    @property
    def entity_dim(self) -> int:
        """Width of entity/relation embeddings (BOW models embed at the word
        width)."""
        if self.model.endswith("bow"):
            return self.emb_dim
        return self.dim

    @property
    def is_inductive(self) -> bool:
        return self.model != "transductive"


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.model not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet (ported: {PORTED_MODELS})")


def _xavier_uniform(shape, generator) -> torch.Tensor:
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    t = torch.empty(shape, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                *, hf_state_dict: dict | None = None) -> dict:
    """Random parameters from `generator` (or BERT weights from an HF state
    dict), placed on `device` (default cuda)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    d = cfg.entity_dim
    params: dict = {"rel_emb": _xavier_uniform((cfg.num_relations, d), generator)}
    if cfg.model == "blp":
        enc = cfg.encoder
        if hf_state_dict is not None:
            params["bert"] = bert_mod.params_from_hf_state_dict(hf_state_dict, enc)
        else:
            params["bert"] = bert_mod.init_bert_params(enc, generator)
        # Bias-free projection; torch Linear default init
        # U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
        bound = 1.0 / enc.hidden_size ** 0.5
        params["proj"] = torch.empty((enc.hidden_size, cfg.dim),
                                     device=generator.device).uniform_(
            -bound, bound, generator=generator)
    else:
        params["ent_emb"] = _xavier_uniform((cfg.num_entities, cfg.dim),
                                            generator)
    return to_device(params, dev)


def to_device(tree, device):
    """Move every tensor of a parameter tree to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16 from the JAX side
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree) -> dict:
    """The TPU package's parameter tree (numpy arrays, or anything
    np.asarray accepts; `layers` stacked or unstacked) as this package's
    tree of CPU tensors, with the same keys and layout."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v) for v in tree)
    return _leaf_from_numpy(tree)


def encode_view(params: dict, cfg: ModelConfig) -> dict:
    """The tree the encoder reads on the inference path: BERT layers
    unstacked (views) and, for a bf16 compute dtype, the layer matrices cast
    once to it (the f32 originals stay untouched)."""
    if "bert" not in params:
        return params
    bert = bert_mod.unstack_layers(params["bert"])
    dt = cfg.encoder.compute_dtype
    if dt != torch.float32:
        bert = dict(bert)
        bert["layers"] = tuple(
            {k: (v.to(dt) if k.endswith("_w") else v) for k, v in lp.items()}
            for lp in bert["layers"])
    out = dict(params)
    out["bert"] = bert
    return out


@torch.no_grad()
def encode_raw(params: dict, cfg: ModelConfig, text_tok, text_mask, *,
               deterministic: bool = True):
    """Encode (B, L) token batches into entity embeddings, WITHOUT the TransE
    normalization. Runs where `params` live."""
    _require_ported(cfg)
    if cfg.model != "blp":
        raise ValueError(f"{cfg.model} is not a text model")
    hidden = bert_mod.bert_encode(params["bert"], text_tok, text_mask,
                                  cfg.encoder, deterministic=deterministic)
    cls = hidden[:, 0].to(torch.float32)
    return torch.matmul(cls, params["proj"].to(torch.float32))


@torch.no_grad()
def encode(params: dict, cfg: ModelConfig, text_tok, text_mask, *,
           deterministic: bool = True, device=None):
    """`encode_raw` + L2 normalization for TransE. Token arrays (numpy or
    tensors) are moved to `device` (default cuda), where `params` must
    live."""
    dev = resolve_device(device)
    tok = torch.as_tensor(text_tok).to(dev)
    mask = None if text_mask is None else torch.as_tensor(text_mask).to(dev)
    out = encode_raw(params, cfg, tok, mask, deterministic=deterministic)
    if cfg.normalize_embs:
        out = scoring.l2_normalize(out)
    return out


@torch.no_grad()
def encode_entity_ids(params: dict, cfg: ModelConfig, entity_ids):
    """Transductive lookup + normalization."""
    _require_ported(cfg)
    ids = torch.as_tensor(entity_ids, device=params["ent_emb"].device).long()
    out = params["ent_emb"][ids]
    if cfg.normalize_embs:
        out = scoring.l2_normalize(out)
    return out
