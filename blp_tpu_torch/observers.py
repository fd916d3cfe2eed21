"""Pluggable metric observers (copy of blp_tpu/observers.py).

The reference streams scalars through Sacred to a MongoObserver that is
attached only when the DB_URI/DB_NAME environment variables are set
(reference: train.py:28-32, _run.log_scalar calls at train.py:202-212).
This module generalizes that into an observer set:

  * JsonlObserver   — always on: one JSON object per log call, flat file,
                      no daemon.
  * TensorBoardObserver — attached when TENSORBOARD_DIR is set (or passed
                      explicitly); uses torch.utils.tensorboard, imported
                      when the observer is made.
  * MongoObserver   — attached when DB_URI and DB_NAME are set, exactly the
                      reference's gating; requires pymongo, imported when the
                      observer is made (it raises there if pymongo is
                      missing, never at import time).

All observers receive every scalar; failures in optional sinks are
non-fatal (a metrics daemon must never kill a training run).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time


class JsonlObserver:
    """One JSON object per log call: {"step": ..., "time": ..., **scalars}."""

    def __init__(self, path: str):
        os.makedirs(osp.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, step, **scalars):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")

    def log_config(self, config: dict):
        # step=-1 keeps the stream homogeneous (every other row has an int
        # step; a string sentinel would break numeric consumers).
        self.log(-1, config={k: repr(v) for k, v in config.items()})

    def close(self):
        pass


class TensorBoardObserver:
    def __init__(self, log_dir: str, run_id: str = ""):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise RuntimeError(
                "TENSORBOARD_DIR is set but torch.utils.tensorboard is not "
                "importable; unset it or install torch with tensorboard "
                "support") from e
        self.writer = SummaryWriter(osp.join(log_dir, run_id))

    def log(self, step, **scalars):
        s = step if isinstance(step, int) else 0
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, s)

    def log_config(self, config: dict):
        self.writer.add_text("config", json.dumps(
            {k: repr(v) for k, v in config.items()}, indent=2))

    def close(self):
        self.writer.close()


class MongoObserver:
    """Reference-parity Mongo sink (train.py:28-32): one document per scalar
    in <DB_NAME>.metrics, keyed by run id."""

    def __init__(self, uri: str, db_name: str, run_id: str,
                 timeout_ms: int = 5000):
        try:
            import pymongo
        except ImportError as e:
            raise RuntimeError(
                "DB_URI/DB_NAME are set but pymongo is not installed; "
                "unset them or install pymongo") from e
        # A short server-selection timeout: MongoClient connects lazily, so
        # an unreachable server would otherwise stall EVERY log call for
        # pymongo's default 30s inside the training loop.
        self.coll = pymongo.MongoClient(
            uri, serverSelectionTimeoutMS=timeout_ms)[db_name].metrics
        self.run_id = run_id

    def log(self, step, **scalars):
        self.coll.insert_one({"run_id": self.run_id, "step": step,
                              "time": time.time(), **scalars})

    def log_config(self, config: dict):
        self.log(-1, config={k: repr(v) for k, v in config.items()})

    def close(self):
        pass


class ObserverSet:
    """Fan-out to every attached observer; optional sinks never raise into
    the training loop."""

    def __init__(self, observers):
        self.observers = list(observers)
        self._warned = set()

    @classmethod
    def from_env(cls, out_dir: str, run_id: str) -> "ObserverSet":
        obs = [JsonlObserver(osp.join(out_dir, f"metrics-{run_id}.jsonl"))]
        tb_dir = os.environ.get("TENSORBOARD_DIR")
        if tb_dir:
            obs.append(TensorBoardObserver(tb_dir, run_id))
        # The reference's exact gating (train.py:28-32).
        uri, db = os.environ.get("DB_URI"), os.environ.get("DB_NAME")
        if uri and db:
            obs.append(MongoObserver(uri, db, run_id))
        return cls(obs)

    def log(self, step, **scalars):
        for i, o in enumerate(self.observers):
            try:
                o.log(step, **scalars)
            except Exception as e:
                if i == 0:  # the primary JSONL sink must not fail silently
                    raise
                name = type(o).__name__
                # Keyed per (sink, method): a config-time failure must not
                # suppress the later, more informative per-step warning.
                if (name, "log") not in self._warned:  # warn once
                    self._warned.add((name, "log"))
                    import logging

                    logging.getLogger("blp_tpu_torch").warning(
                        f"metrics sink {name} failed ({e!r}); further "
                        f"failures from it will be dropped silently")

    def log_config(self, config: dict):
        # Same contract as log(): the primary JSONL sink must not fail
        # silently — a run whose output dir is unwritable should die at
        # config time, not log nothing and say nothing.
        for i, o in enumerate(self.observers):
            try:
                o.log_config(config)
            except Exception as e:
                if i == 0:
                    raise
                name = type(o).__name__
                if (name, "log_config") not in self._warned:
                    self._warned.add((name, "log_config"))
                    import logging

                    logging.getLogger("blp_tpu_torch").warning(
                        f"metrics sink {name} failed on log_config ({e!r})")

    def close(self):
        for o in self.observers:
            try:
                o.close()
            except Exception:
                pass
