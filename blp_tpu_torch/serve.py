"""Serving: load a trained model and answer link-prediction queries.

Port of blp_tpu/serve.py. Given a checkpoint, serve top-k tail (or head)
predictions for (head, relation) queries over a candidate entity universe:
the candidate table is encoded once (or loaded from an `ent_emb-*.npz`
export), each query batch runs one top-k pass over it, and ad-hoc entities
can be encoded from raw description text.

Usage (library):
    srv = LinkPredictor.from_checkpoint("output/model-X.npz", mcfg,
                                        tokenizer=tok)
    srv.set_candidates_from_texts(ids, texts)        # or .set_candidates(table, ids)
    scores, ents = srv.predict_tails(head_texts=["..."], rels=[3], k=10)

CLI over a packed dataset:
    python -m blp_tpu_torch.serve checkpoint=... dataset=... model=... [device=cpu] [serve]
"""

from __future__ import annotations

import dataclasses
import json
import queue
import time

import numpy as np
import torch

from blp_tpu_torch import checkpoint as ckpt
from blp_tpu_torch.models import blp
from blp_tpu_torch.ops import ranking
from blp_tpu_torch.utils import resolve_device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class LinkPredictor:
    params: dict
    cfg: blp.ModelConfig
    tokenizer: object | None = None
    max_len: int = 32
    tile: int = 65536
    # Accepted for the TPU package's signature; selection is always exact
    # (exact top-k is a superset of the approximate recall).
    approx: bool = False
    device: object = None           # default cuda; "cpu" for the plain paths
    # candidate state
    _table: torch.Tensor | None = None          # (Np, d) padded
    _num_valid: int = 0
    _candidate_ids: np.ndarray | None = None    # (N,) external ids
    # cached encode view of params (unstacked layers, compute-dtype matrices)
    _params_enc: dict | None = None
    _params_enc_src: dict | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = blp.to_device(self.params, self.device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: blp.ModelConfig, *,
                        tokenizer=None, max_len: int = 32, tile: int = 65536,
                        device=None) -> "LinkPredictor":
        """Load a model file written by either package (the tree is rebuilt
        from the file's own structure record)."""
        params, _ = ckpt.load_pytree(path)
        return cls(params=params, cfg=cfg, tokenizer=tokenizer,
                   max_len=max_len, tile=tile, device=device)

    # -- encoding ------------------------------------------------------------

    def embed_texts(self, texts: list[str]) -> torch.Tensor:
        """Encode raw description texts into entity embeddings (B, d)."""
        if self.tokenizer is None:
            raise ValueError("a tokenizer is required to embed raw text")
        tok, mask = self.tokenizer.batch_encode(texts, self.max_len)
        return self._encode(self.params, tok, mask)

    def _encode(self, params, tok, mask):
        # The encode view is cached on the params dict's identity: replace
        # srv.params wholesale to swap weights, or call
        # invalidate_encode_cache() after mutating it in place.
        if self._params_enc is None or params is not self._params_enc_src:
            self._params_enc_src = params
            self._params_enc = blp.encode_view(params, self.cfg)
        return blp.encode(self._params_enc, self.cfg, tok, mask,
                          device=self.device)

    def invalidate_encode_cache(self) -> None:
        """Drop the cached encode view (needed only after mutating
        `self.params` leaves in place)."""
        self._params_enc = self._params_enc_src = None

    # -- candidate universe ----------------------------------------------------

    def set_candidates(self, table, ids=None) -> None:
        """Install a precomputed (N, d) candidate table."""
        table = torch.as_tensor(table).to(self.device, torch.float32)
        n = int(table.shape[0])
        n_pad = _round_up(max(n, 1), self.tile)
        if n_pad > n:
            table = torch.nn.functional.pad(table, (0, 0, 0, n_pad - n))
        self._table = table
        self._num_valid = n
        self._candidate_ids = (np.asarray(ids) if ids is not None
                               else np.arange(n))

    def set_candidates_from_export(self, out_dir: str, run_id: str) -> None:
        """Install candidates from a training run's embedding export."""
        from blp_tpu_torch.utils import load_embedding_export

        table, ids = load_embedding_export(out_dir, run_id)
        self.set_candidates(table, ids)

    def set_candidates_from_texts(self, ids, texts: list[str],
                                  batch_size: int = 512) -> None:
        if self.tokenizer is None:
            raise ValueError("a tokenizer is required to embed raw text")
        chunks = []
        for s in range(0, len(texts), batch_size):
            chunk = texts[s:s + batch_size]
            pad = batch_size - len(chunk)
            tok, mask = self.tokenizer.batch_encode(chunk + [""] * pad,
                                                    self.max_len)
            mask[len(chunk):, 0] = 1.0
            chunks.append(self._encode(self.params, tok, mask)[:len(chunk)])
        self.set_candidates(torch.cat(chunks, dim=0), ids)

    # -- queries ---------------------------------------------------------------

    #: Dense-path budget: max B * Np score elements (fp32) materialized at
    #: once — 320M = 1.28 GB.
    DENSE_TOPK_BUDGET = 320_000_000

    @torch.no_grad()
    def _topk(self, fixed: torch.Tensor, rels, k: int, corrupt: str):
        if self._table is None:
            raise ValueError("no candidate table installed")
        rel_idx = torch.as_tensor(np.asarray(rels, np.int64), device=self.device)
        rel_emb = self.params["rel_emb"][rel_idx]
        n_pad = self._table.shape[0]
        if fixed.shape[0] * n_pad <= self.DENSE_TOPK_BUDGET:
            scores, cols = ranking.dense_top_k(
                self._table, fixed, rel_emb, self._num_valid, k=k,
                rel_model=self.cfg.rel_model, corrupt=corrupt,
                approx=self.approx)
        else:
            scores, cols = ranking.tiled_top_k(
                self._table, fixed, rel_emb, self._num_valid, k=k,
                rel_model=self.cfg.rel_model, corrupt=corrupt,
                tile=min(self.tile, n_pad), approx=self.approx)
        cols = cols.cpu().numpy()
        ents = np.where(cols >= 0, self._candidate_ids[np.clip(cols, 0, None)],
                        -1)
        return scores.cpu().numpy(), ents

    def predict_tails(self, *, rels, head_texts=None, head_emb=None,
                      k: int = 10):
        """Top-k tail candidates for (head, rel, ?). Heads given as raw
        description texts (inductive) or precomputed embeddings (B, d)."""
        fixed = (self.embed_texts(head_texts) if head_texts is not None
                 else torch.as_tensor(head_emb).to(self.device, torch.float32))
        return self._topk(fixed, rels, k, corrupt="tail")

    def predict_heads(self, *, rels, tail_texts=None, tail_emb=None,
                      k: int = 10):
        """Top-k head candidates for (?, rel, tail)."""
        fixed = (self.embed_texts(tail_texts) if tail_texts is not None
                 else torch.as_tensor(tail_emb).to(self.device, torch.float32))
        return self._topk(fixed, rels, k, corrupt="head")


def serve_loop(srv: LinkPredictor, requests, write, *,
               ent_ids: dict | None = None, rel_ids: dict | None = None,
               max_batch: int = 64, linger_s: float = 0.002) -> dict:
    """Long-running request loop with micro-batching.

    requests: a queue.Queue of JSON strings (None terminates). Each request:

        {"id": any, "op": "tails"|"heads", "rel": <id or name>, "k": 10,
         "head"/"tail": <entity name>            # candidate-table lookup, or
         "head_text"/"tail_text": <description>} # ad-hoc encode

    write: called with one JSON line per response,
    `{"id":..., "entities": [...], "scores": [...]}` (entities as names when
    `ent_ids` is given, else candidate ids) or `{"id":..., "error": "..."}`.

    Batching: drains up to `max_batch` queued requests (waiting `linger_s`
    for stragglers after the first), groups them by (op, k, input kind), and
    runs one top-k pass per group. Returns {"served", "errors", "batches"}.
    """
    id2ent = None if ent_ids is None else {v: k for k, v in ent_ids.items()}
    stats = {"served": 0, "errors": 0, "batches": 0}

    def fail(rid, msg):
        stats["errors"] += 1
        write(json.dumps({"id": rid, "error": msg}))

    num_rels = int(srv.params["rel_emb"].shape[0])

    def resolve_rel(r):
        if isinstance(r, str):
            if rel_ids is None or r not in rel_ids:
                raise KeyError(f"unknown relation {r!r}")
            return rel_ids[r]
        r = int(r)
        # Range-check explicitly so a bad id is an error line for this
        # request, with the same message as the TPU package's.
        if not 0 <= r < num_rels:
            raise KeyError(f"relation id {r} out of range [0, {num_rels})")
        return r

    def run_group(group):
        # group: list of (rid, op, k, fixed_kind, fixed_value, rel_id). Padded
        # to a power-of-two bucket by repeating the last request, as the TPU
        # package does, so batch shapes stay few.
        _, op, k, kind, _, _ = group[0]
        bucket = 1
        while bucket < len(group):
            bucket *= 2
        pad = bucket - len(group)
        rels = [g[5] for g in group] + [group[-1][5]] * pad
        vals = [g[4] for g in group] + [group[-1][4]] * pad
        if kind == "text":
            fixed = srv.embed_texts(vals)
        else:
            fixed = srv._table[torch.as_tensor(vals, device=srv.device)]
        fn = srv.predict_tails if op == "tails" else srv.predict_heads
        scores, ents = fn(rels=rels, **{("head_emb" if op == "tails" else
                                        "tail_emb"): fixed}, k=k)
        stats["batches"] += 1
        for i, g in enumerate(group):
            names = ([id2ent.get(int(e), "?") if e >= 0 else None
                      for e in ents[i]] if id2ent is not None
                     else [int(e) for e in ents[i]])
            write(json.dumps({"id": g[0], "entities": names,
                              "scores": np.round(scores[i], 6).tolist()}))
            stats["served"] += 1

    done = False
    while not done:
        batch = []
        try:
            first = requests.get()
        except (EOFError, KeyboardInterrupt):
            break
        if first is None:
            break
        batch.append(first)
        deadline = time.monotonic() + linger_s
        while len(batch) < max_batch:
            try:
                nxt = requests.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                break
            if nxt is None:
                done = True
                break
            batch.append(nxt)

        groups: dict = {}
        for line in batch:
            line = line.strip()
            if not line:
                continue
            rid = None
            try:
                req = json.loads(line)
                rid = req.get("id")
                op = req.get("op", "tails")
                if op not in ("tails", "heads"):
                    raise ValueError(f"unknown op {op!r}")
                k = int(req.get("k", 10))
                rel = resolve_rel(req["rel"])
                side = "head" if op == "tails" else "tail"
                if f"{side}_text" in req:
                    kind, val = "text", str(req[f"{side}_text"])
                elif side in req:
                    name = req[side]
                    if ent_ids is None or name not in ent_ids:
                        raise KeyError(f"unknown entity {name!r}")
                    if srv._candidate_ids is None:
                        raise ValueError("no candidate table installed")
                    rows = np.flatnonzero(srv._candidate_ids == ent_ids[name])
                    if not len(rows):
                        raise KeyError(f"{name!r} not in the candidate table")
                    kind, val = "row", int(rows[0])
                else:
                    raise KeyError(f"request needs {side!r} or '{side}_text'")
                groups.setdefault((op, k, kind), []).append(
                    (rid, op, k, kind, val, rel))
            except Exception as e:  # noqa: BLE001 — per-request isolation
                fail(rid, f"{type(e).__name__}: {e}")
        for group in groups.values():
            try:
                run_group(group)
            except Exception as e:  # noqa: BLE001
                for g in group:
                    fail(g[0], f"{type(e).__name__}: {e}")
    return stats


def main(argv=None):
    """CLI: load a checkpoint and dataset, build the candidate table, and
    either answer a few test-split queries (default) or, with a `serve`
    argument, run the stdin-JSONL request daemon (serve_loop). Runs on the
    `device=` key (default cuda)."""
    import sys
    import threading

    from blp_tpu_torch import train as train_mod
    from blp_tpu_torch.config import parse_overrides
    from blp_tpu_torch.data.datasets import GraphData, TextGraphData

    args = argv if argv is not None else sys.argv[1:]
    cfg = parse_overrides([a for a in args if "=" in a or a == "with"])
    tokenizer = train_mod.make_tokenizer(cfg)
    text = TextGraphData.load(
        cfg.triples_file("train"), tokenizer=tokenizer, max_len=cfg.max_len,
        write_maps=True, use_cached_text=cfg.use_cached_text)
    test = GraphData.load(cfg.triples_file("test"))
    mcfg = train_mod.make_model_config(cfg, tokenizer, len(text.rel_ids),
                                       len(text.ent_ids))
    srv = LinkPredictor.from_checkpoint(cfg.checkpoint, mcfg,
                                        tokenizer=tokenizer,
                                        max_len=cfg.max_len, tile=cfg.tile,
                                        device=cfg.device)
    # Candidate universe: every entity with a description, encoded in chunks.
    ents = np.arange(len(text.ent_ids))
    chunks = []
    for s in range(0, len(ents), cfg.emb_batch_size):
        tok, mask = text.get_entity_descriptions(ents[s:s + cfg.emb_batch_size])
        chunks.append(srv._encode(srv.params, tok, mask))
    table = torch.cat(chunks, dim=0)
    srv.set_candidates(table, ents)

    if "serve" in args:
        # Daemon mode: JSONL requests on stdin, JSONL responses on stdout.
        req_q: "queue.Queue[str | None]" = queue.Queue()

        def reader():
            for line in sys.stdin:
                req_q.put(line)
            req_q.put(None)

        threading.Thread(target=reader, daemon=True).start()
        print(json.dumps({"ready": True, "num_candidates": len(ents)}),
              flush=True)
        stats = serve_loop(srv, req_q, lambda s: print(s, flush=True),
                           ent_ids=text.ent_ids, rel_ids=text.rel_ids)
        print(json.dumps({"done": True, **stats}), flush=True)
        return

    ent_name = {v: k for k, v in text.ent_ids.items()}
    rel_name = {v: k for k, v in text.rel_ids.items()}
    q = test.triples[:4]  # (T, 3) [head, tail, rel]
    scores, pred = srv.predict_tails(head_emb=table[torch.as_tensor(q[:, 0]).long()],
                                     rels=q[:, 2], k=5)
    for i, (h, t, r) in enumerate(q):
        names = [ent_name.get(int(e), "?") for e in pred[i]]
        print(f"({ent_name[int(h)]}, {rel_name[int(r)]}, ?) -> {names}  "
              f"true={ent_name[int(t)]}  scores={np.round(scores[i], 3).tolist()}")


if __name__ == "__main__":
    main()
