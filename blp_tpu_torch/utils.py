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


def card_stats(device) -> dict:
    """What a measuring tool records of the card it ran on: its name, its
    power limit as nvidia-smi prints it, and the peak device memory since the
    last reset (`max_memory_allocated`, GiB). Empty on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    import subprocess

    index = torch.cuda.current_device() if dev.index is None else dev.index
    limit = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(dev), "power_limit": limit,
            "peak_mem_gib": round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)}


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from `seed` and `data` (the splitmix64 finalizer
    over their combination): the port's counterpart of
    `jax.random.fold_in`, used to derive per-step and per-site generator
    seeds on the host, with no device work."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


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
