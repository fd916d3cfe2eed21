"""Experiment set-up helpers shared with the serve CLI.

Port of `make_tokenizer` and `make_model_config` from blp_tpu/train.py. The
training and node-classification entry points come with the training slice.
"""

from __future__ import annotations

import os.path as osp

import torch

from blp_tpu_torch.config import ExperimentConfig
from blp_tpu_torch.data.tokenizers import GloVeTokenizer, WordPieceTokenizer
from blp_tpu_torch.models import bert, blp


def make_tokenizer(cfg: ExperimentConfig):
    if cfg.model in ("blp", "bert-bow", "bert-dkrl"):
        vocab = cfg.vocab_file or osp.join(cfg.dataset_dir, "vocab.txt")
        if not osp.exists(vocab):
            raise FileNotFoundError(
                f"WordPiece vocab not found at {vocab}; there is no network "
                f"access — provide vocab_file= pointing at a local "
                f"bert-base-cased vocab.txt")
        return WordPieceTokenizer(vocab, do_lower_case=False)
    maps = cfg.glove_file or osp.join(cfg.data_dir, "glove", "glove.6B.300d-maps.pt")
    if maps.endswith(".pt"):
        maps_path = maps.replace(".pt", "-maps.pt") if "-maps" not in maps else maps
    else:
        maps_path = maps
    return GloVeTokenizer(maps_path)


def make_model_config(cfg: ExperimentConfig, tokenizer, num_relations: int,
                      num_entities: int) -> blp.ModelConfig:
    encoder = None
    emb_dim, vocab_size = 300, 0
    if cfg.model == "blp":
        vocab_size = len(tokenizer.vocab)
        numerics = dict(
            compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
            remat=cfg.remat, fast_train=cfg.fast_train,
            dropout_bits=cfg.dropout_bits)
        if cfg.encoder_name == "tiny":
            encoder = bert.BertConfig.tiny(vocab_size=max(vocab_size, 128),
                                           **numerics)
        else:
            encoder = bert.BertConfig(vocab_size=vocab_size, **numerics)
    elif cfg.model.startswith("bert"):
        vocab_size = len(tokenizer.vocab)
        emb_dim = 768 if cfg.encoder_name != "tiny" else 32
    elif cfg.model.startswith("glove"):
        vocab_size = len(tokenizer.word2idx)
        emb_dim = 300
    return blp.ModelConfig(
        model=cfg.model, rel_model=cfg.rel_model, loss_fn=cfg.loss_fn,
        dim=cfg.dim, num_relations=num_relations, num_entities=num_entities,
        regularizer=cfg.regularizer, emb_dim=emb_dim, vocab_size=vocab_size,
        encoder=encoder)
