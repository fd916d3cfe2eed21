"""Small shared utilities (copy of blp_tpu/utils.py, plus device choice)."""

from __future__ import annotations

import logging

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    there is none — an entry point never drops silently to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def make_ent2idx(entities: np.ndarray, max_ent_id: int) -> np.ndarray:
    """Entity id -> position among `entities`; -1 for holes
    (reference: utils.py:31-43)."""
    ent2idx = np.full(max_ent_id + 1, -1, np.int64)
    ent2idx[entities] = np.arange(len(entities))
    return ent2idx


def load_embedding_export(out_dir: str, run_id: str):
    """Load a training run's entity-embedding export as
    (ent_emb (N, d) float32, entities (N,) int64) numpy arrays.

    Accepts BOTH artifact families, so a reference run's outputs feed this
    framework's node_classification / serving directly:
      * this framework's  ent_emb-{id}.npz  (keys ent_emb, entities;
        written by train.link_prediction), preferred when both exist;
      * the reference's   ent_emb-{id}.pt + ents-{id}.pt  torch pair
        (reference train.py:403-405; its loader squeezes and unwraps a
        (emb, ...) tuple, train.py:410-419 — mirrored here).
    """
    import os.path as osp

    npz = osp.join(out_dir, f"ent_emb-{run_id}.npz")
    if osp.exists(npz):
        data = np.load(npz)
        return (np.asarray(data["ent_emb"], np.float32),
                np.asarray(data["entities"], np.int64))
    pt = osp.join(out_dir, f"ent_emb-{run_id}.pt")
    ents_pt = osp.join(out_dir, f"ents-{run_id}.pt")
    if osp.exists(pt):
        if not osp.exists(ents_pt):
            raise FileNotFoundError(
                f"{pt} exists but its entity-id file {ents_pt} is missing "
                f"(the reference writes them as a pair, train.py:403-405)")
        import torch

        emb = torch.load(pt, map_location="cpu", weights_only=False)
        if isinstance(emb, tuple):  # reference: train.py:411-412
            emb = emb[0]
        ents = torch.load(ents_pt, map_location="cpu", weights_only=False)
        arr = np.asarray(emb.detach().numpy(), np.float32)
        # The reference loader squeezes wrapper axes (train.py:414); a bare
        # .squeeze() would also collapse a legitimate single-entity (1, d)
        # export to (d,) and crash shape-indexing consumers — restore 2-D.
        arr = arr.squeeze()
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        return arr, np.asarray(ents.numpy(), np.int64)
    raise FileNotFoundError(
        f"no embedding export for run {run_id!r} in {out_dir!r}: looked for "
        f"{npz} and {pt} (+ {ents_pt})")


def get_logger(name: str = "blp_tpu_torch") -> logging.Logger:
    """Timestamped stdout logger (reference: utils.py:171-183)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        ch = logging.StreamHandler()
        fmt = logging.Formatter(
            "%(asctime)s - %(levelname)s - %(name)s - %(message)s", datefmt="%H:%M:%S")
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        logger.setLevel("INFO")
        logger.propagate = False
    return logger
