"""Model assembly: the BLP configuration, init, encode and the training loss.

Port of blp_tpu/models/blp.py, the whole model family:

  blp          BERT encoder -> [CLS] -> bias-free projection to dim
  bert-bow     BOW over BERT's word-embedding table (entity width 768)
  bert-dkrl    DKRL CNN over BERT's word-embedding table
  glove-bow    BOW over a GloVe table (entity width 300)
  glove-dkrl   DKRL CNN over a GloVe table
  transductive xavier entity lookup table (no text)

Entity embeddings are L2-normalized iff the relational model is TransE.
Parameters are plain dicts of tensors in the TPU package's layout;
`params_from_jax` turns that package's parameter tree (numpy leaves) into
this one.

Deterministic encodes are inference and run under `no_grad`; the training
pass (`deterministic=False`, `train_loss`) builds an autograd graph.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from blp_tpu_torch.models import bert as bert_mod
from blp_tpu_torch.models import encoders, scoring
from blp_tpu_torch.ops import sddmm
from blp_tpu_torch.utils import resolve_device

TEXT_MODELS = ("blp", "bert-bow", "bert-dkrl", "glove-bow", "glove-dkrl")
ALL_MODELS = TEXT_MODELS + ("transductive",)
#: Models whose data pipeline drops stopwords (reference: train.py:252-253).
DROP_STOPWORD_MODELS = frozenset({"bert-bow", "bert-dkrl", "glove-bow", "glove-dkrl"})


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
    sddmm_pallas: bool = False     # K3: fused pos+neg scoring (ops/sddmm.py)

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


def _xavier_uniform(shape, generator) -> torch.Tensor:
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    t = torch.empty(shape, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                *, word_embeddings=None, hf_state_dict: dict | None = None) -> dict:
    """Random parameters from `generator`, placed on `device` (default
    cuda).

    word_embeddings: an initial (V, E) word table for the bow/dkrl models
      (BERT's word embeddings for the bert- variants, a GloVe tensor for the
      glove- ones); 0.02 * N(0, 1) of shape (vocab_size, emb_dim) if omitted.
    hf_state_dict: BERT weights from an HF BertModel state dict (`blp`).
    """
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
    elif cfg.model == "transductive":
        params["ent_emb"] = encoders.init_entity_table(
            generator, cfg.num_entities, cfg.dim)
    else:
        if word_embeddings is not None:
            we = torch.as_tensor(word_embeddings).to(torch.float32)
        else:
            if cfg.vocab_size <= 0:
                raise ValueError("vocab_size required when word_embeddings not given")
            we = 0.02 * torch.randn((cfg.vocab_size, cfg.emb_dim),
                                    device=generator.device, generator=generator)
        if we.shape[-1] != cfg.emb_dim:
            raise ValueError(f"word_embeddings width {we.shape[-1]} != emb_dim "
                             f"{cfg.emb_dim}")
        params["word_emb"] = we
        if cfg.model.endswith("dkrl"):
            params["dkrl"] = encoders.init_dkrl_params(generator, cfg.emb_dim,
                                                       cfg.dim)
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
    return torch.from_numpy(np.array(a, order="C"))   # keeps 0-d leaves 0-d


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


def encode_raw(params: dict, cfg: ModelConfig, text_tok, text_mask, *,
               deterministic: bool = True, dropout_seed: int | None = None,
               part: bert_mod.Part | None = None):
    """Encode (B, L) token batches into entity embeddings, WITHOUT the TransE
    normalization. Runs where `params` live; deterministic=False is the
    training pass (dropout from `dropout_seed`, with a graph; the word
    models have no dropout). part: this process's share of a parallel
    training pass of the BERT encoder (models/bert.py `Part`)."""
    grad_ctx = torch.no_grad() if deterministic else contextlib.nullcontext()
    with grad_ctx:
        if cfg.model == "blp":
            hidden = bert_mod.bert_encode(params["bert"], text_tok, text_mask,
                                          cfg.encoder, deterministic=deterministic,
                                          dropout_seed=dropout_seed, part=part)
            cls = hidden[:, 0].to(torch.float32)
            return torch.matmul(cls, params["proj"].to(torch.float32))
        if cfg.model.endswith("bow"):
            return encoders.bow_encode(params["word_emb"], text_tok, text_mask)
        if cfg.model.endswith("dkrl"):
            return encoders.dkrl_encode(params["dkrl"], params["word_emb"],
                                        text_tok, text_mask)
    raise ValueError(f"{cfg.model} is not a text model")


def encode(params: dict, cfg: ModelConfig, text_tok, text_mask, *,
           deterministic: bool = True, dropout_seed: int | None = None,
           device=None):
    """`encode_raw` + L2 normalization for TransE. Token arrays (numpy or
    tensors) are moved to `device` (default cuda), where `params` must
    live."""
    dev = resolve_device(device)
    tok = torch.as_tensor(text_tok).to(dev)
    mask = None if text_mask is None else torch.as_tensor(text_mask).to(dev)
    out = encode_raw(params, cfg, tok, mask, deterministic=deterministic,
                     dropout_seed=dropout_seed)
    if cfg.normalize_embs:
        out = scoring.l2_normalize(out)
    return out


def encode_entity_ids(params: dict, cfg: ModelConfig, entity_ids):
    """Transductive lookup + normalization (differentiable in
    `params["ent_emb"]` when it requires grad)."""
    ids = torch.as_tensor(entity_ids, device=params["ent_emb"].device).long()
    out = params["ent_emb"][ids]
    if cfg.normalize_embs:
        out = scoring.l2_normalize(out)
    return out


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               deterministic: bool = False, dropout_seed: int | None = None,
               part: bert_mod.Part | None = None, gather=None):
    """Link-prediction loss for one batch (0-d float32 tensor on the
    batch's device).

    batch (tensors on the params' device):
      text models:  text_tok (B, 2, L), text_mask (B, 2, L)
      transductive: pos_pairs (B, 2) entity ids
      both:         rels (B,), neg_idx (B, K, 2)
    With `cfg.sddmm_pallas` the positive and negative scores come from K3
    (ops/sddmm.py); otherwise from scoring.compute_loss.

    Data-parallel steps (parallel/train_parallel.py) pass this rank's rows
    of the batch, their place in the whole batch (`part`, in entity rows)
    and `gather`, which stacks every rank's rows (with autograd): the
    entity embeddings and relations are gathered before scoring, so
    `neg_idx` indexes the whole batch.
    """
    if cfg.is_inductive:
        text_tok = batch["text_tok"]
        B, two, L = text_tok.shape
        mask = batch.get("text_mask")
        flat_mask = None if mask is None else mask.reshape(B * two, L)
        ent = encode_raw(params, cfg, text_tok.reshape(B * two, L), flat_mask,
                         deterministic=deterministic, dropout_seed=dropout_seed,
                         part=part)
        if cfg.normalize_embs:
            ent = scoring.l2_normalize(ent)
        ent = ent.reshape(B, 2, -1)
    else:
        ent = encode_entity_ids(params, cfg, batch["pos_pairs"])
    rels = batch["rels"].reshape(-1)
    if gather is not None:
        ent, rels = gather(ent), gather(rels)
    return entity_loss(params, cfg, ent, rels, batch["neg_idx"])


def entity_loss(params: dict, cfg: ModelConfig, ent, rels, neg_idx):
    """The loss of a batch's entity embeddings ent (B, 2, d), normalized as
    the model normalizes them, with relations rels (B,) and negatives
    neg_idx (B, K, 2): through K3 with `cfg.sddmm_pallas`, else
    scoring.compute_loss."""
    rel_embs = params["rel_emb"][rels.long()]
    if cfg.sddmm_pallas:
        pos, neg = sddmm.sddmm_scores(
            ent.reshape(-1, ent.shape[-1]), rel_embs, neg_idx, cfg.rel_model)
        total = scoring.get_loss_fn(cfg.loss_fn)(pos, neg)
        if cfg.regularizer:
            total = total + cfg.regularizer * scoring.l2_regularization(
                ent[:, 0, :], ent[:, 1, :], rel_embs)
        return total
    return scoring.compute_loss(
        ent, rel_embs, neg_idx,
        rel_model=cfg.rel_model, loss_fn=cfg.loss_fn, regularizer=cfg.regularizer)
