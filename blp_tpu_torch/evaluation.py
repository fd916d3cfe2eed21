"""Two-phase full-ranking link-prediction evaluation (single device).

Port of blp_tpu/evaluation.py. Phase 1 encodes every candidate entity into
an (Np, d) table in fixed-size chunks; phase 2 streams each eval batch
against the table with tie-aware rank counts and sparse filtered
corrections. Same semantics as the TPU package: raw and filtered
MRR/hits@{1,3,10}, head-corruption-first ordering of the reciprocals, the
self-tie, and the new-entity and relation-category breakdowns — without
materializing (B, N) scores. TransE ranks through K1 (ops/transe_rank.py:
the CUDA kernel on the card, its plain version on the CPU); the bilinear
scorers through the plain tiled stream (ops/ranking.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from blp_tpu_torch import metrics
from blp_tpu_torch.data.datasets import CATEGORY_IDS
from blp_tpu_torch.data.filtering import FilterIndex, build_filters
from blp_tpu_torch.models import blp
from blp_tpu_torch.ops import ranking, transe_rank
from blp_tpu_torch.utils import make_ent2idx, resolve_device

HIT_POSITIONS = (1, 3, 10)


@dataclasses.dataclass
class EvalResult:
    mrr: float
    hits: dict[int, float]
    mrr_filt: float | None = None
    hits_filt: dict[int, float] | None = None
    mrr_by_position: np.ndarray | None = None   # (3,) both/head/tail-new
    mrr_by_category: np.ndarray | None = None   # (2, 4)
    ent_emb: np.ndarray | None = None
    entities: np.ndarray | None = None

    def scalars(self, prefix: str) -> dict[str, float]:
        out = {f"{prefix}_mrr": self.mrr}
        for k, v in self.hits.items():
            out[f"{prefix}_hits@{k}"] = v
        if self.mrr_filt is not None:
            out[f"{prefix}_mrr_filt"] = self.mrr_filt
            for k, v in self.hits_filt.items():
                out[f"{prefix}_hits@{k}_filt"] = v
        if self.mrr_by_position is not None:
            for i, name in enumerate(("both_new", "head_new", "tail_new")):
                out[f"{prefix}_mrr_filt_{name}"] = float(self.mrr_by_position[i])
        if self.mrr_by_category is not None:
            for case_i, case in enumerate(("pred_head", "pred_tail")):
                for cat, cat_id in CATEGORY_IDS.items():
                    out[f"{prefix}_{case}_{cat}_mrr"] = float(
                        self.mrr_by_category[case_i, cat_id])
        return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_entity_table(
    encode_batch: Callable[[np.ndarray, np.ndarray], torch.Tensor],
    text_data,
    entities: np.ndarray,
    *,
    emb_batch_size: int,
    dim: int,
    device,
    pad_to: int = 1,
    chunk_multiple: int = 256,
    log=None,
) -> torch.Tensor:
    """Encode all candidate entities into an (Np, d) float32 table on
    `device`, in chunks of emb_batch_size (the last chunk padded; padded rows
    get mask[:, 0] = 1 so no row is all-masked)."""
    n = len(entities)
    n_pad = _round_up(max(n, 1), pad_to)
    emb_batch_size = min(_round_up(emb_batch_size, chunk_multiple),
                         _round_up(max(n, 1), chunk_multiple))
    chunks = []
    for ci, start in enumerate(range(0, n, emb_batch_size)):
        ids = entities[start:start + emb_batch_size]
        tok, mask = text_data.get_entity_descriptions(ids)
        if len(ids) < emb_batch_size:
            pad = emb_batch_size - len(ids)
            tok = np.pad(tok, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
            mask[len(ids):, 0] = 1.0
        chunks.append(encode_batch(tok, mask)[:len(ids)])
        if log and ci % 20 == 0:
            log.info(f"[encode {start + len(ids):,}/{n:,}]")
    table = torch.zeros((n_pad, dim), dtype=torch.float32, device=device)
    if chunks:
        table[:n] = torch.cat(chunks, dim=0)
    return table


def _rank_batch(table, head_pos, tail_pos, rel_table, rel_ids, num_valid: int,
                heads_filter, tails_filter, *, rel_model: str,
                tile: int) -> dict:
    """Raw + filtered rank counts for one eval batch, both directions, with
    the self-tie added. 'h_' prefixes head corruption, 't_' tail
    corruption; each value is (B,) int32."""
    rel_emb = rel_table[rel_ids]
    head_emb = table[head_pos]
    tail_emb = table[tail_pos]
    h_true = ranking.score_pairs(head_emb, tail_emb, rel_emb,
                                 rel_model=rel_model, corrupt="head")[:, None]
    t_true = ranking.score_pairs(tail_emb, head_emb, rel_emb,
                                 rel_model=rel_model, corrupt="tail")[:, None]
    if rel_model == "transe":
        c = transe_rank.transe_tiled_rank_counts_bidir(
            table, head_emb, tail_emb, rel_emb, h_true, t_true, head_pos,
            tail_pos, heads_filter, tails_filter, num_valid)
    else:
        c = ranking.tiled_rank_counts_bidir(
            table, head_emb, tail_emb, rel_emb, h_true, t_true, head_pos,
            tail_pos, heads_filter, tails_filter, num_valid,
            rel_model=rel_model, tile=tile)
    # Self-tie: the true entity adds exactly 1 to geq, raw and filtered.
    return {k: v + 1 if k.endswith("_geq") else v for k, v in c.items()}


def eval_link_prediction(
    params: dict,
    cfg: blp.ModelConfig,
    eval_triples: np.ndarray,
    text_data,
    entities: np.ndarray,
    *,
    batch_size: int = 64,
    emb_batch_size: int = 2048,
    tile: int = 65536,
    filter_index: FilterIndex | None = None,
    new_entities: np.ndarray | None = None,
    rel_categories: np.ndarray | None = None,
    max_num_batches: int | None = None,
    return_embeddings: bool = False,
    ent_emb: torch.Tensor | None = None,
    mesh=None,
    device=None,
    log=None,
) -> EvalResult:
    """Full-ranking evaluation over a candidate entity set.

    eval_triples: (T, 3) [head, tail, rel]; entities: the ranking universe;
    filter_index: known-true triples (None = raw only); new_entities: ids
    unseen in training (position breakdown); rel_categories: (num_rels,)
    category ids; ent_emb: optionally a precomputed (padded) table. Runs on
    `device` (default cuda), where `params` must live. `mesh` (the TPU
    package's candidate-sharded evaluation) is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError("mesh evaluation is not ported yet")
    dev = resolve_device(device)
    compute_filtered = filter_index is not None
    max_ent_id = int(max(entities.max(), eval_triples[:, :2].max()))
    ent2idx = make_ent2idx(entities, max_ent_id)
    n = len(entities)
    tile = min(tile, _round_up(max(n, 1), 256))
    n_pad = _round_up(n, tile)

    if ent_emb is None:
        if cfg.is_inductive:
            params_enc = blp.encode_view(params, cfg)

            def encode_batch(tok, mask):
                return blp.encode(params_enc, cfg, tok, mask, device=dev)

            # 4 keeps BERT sequence packing engaged (packing needs B % 4 == 0).
            ent_emb = build_entity_table(
                encode_batch, text_data, entities,
                emb_batch_size=emb_batch_size, dim=cfg.entity_dim, device=dev,
                pad_to=tile, chunk_multiple=4, log=log)
        else:
            table = blp.encode_entity_ids(params, cfg, entities)
            ent_emb = torch.zeros((n_pad, cfg.entity_dim), device=dev)
            ent_emb[:n] = table
    else:
        if not isinstance(ent_emb, torch.Tensor):
            ent_emb = torch.from_numpy(np.array(ent_emb, np.float32))
        ent_emb = ent_emb.to(dev, torch.float32)
        if ent_emb.shape[0] != n_pad:
            # Pad up to a multiple of the tile, never truncate real rows.
            target = max(n_pad, _round_up(int(ent_emb.shape[0]), tile))
            if target > ent_emb.shape[0]:
                ent_emb = torch.nn.functional.pad(
                    ent_emb, (0, 0, 0, target - ent_emb.shape[0]))

    rel_emb_table = params["rel_emb"].to(dev)

    t_total = len(eval_triples)
    n_batches = -(-t_total // batch_size)
    if max_num_batches is not None:
        n_batches = min(n_batches, max_num_batches)

    filter_pad = 8
    if compute_filtered:
        # One bucketed width across all batches.
        hf_all, tf_all = build_filters(eval_triples, filter_index, ent2idx)
        filter_pad = max(hf_all.shape[1], tf_all.shape[1])
    empty_filters = np.full((batch_size, filter_pad), -1, np.int32)

    def on_dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    pending, triples_seen = [], []
    for bi in range(n_batches):
        batch = eval_triples[bi * batch_size:(bi + 1) * batch_size]
        real = len(batch)
        if real < batch_size:  # pad; padded rows sliced off below
            batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - real, 0)])
        head_pos = ent2idx[batch[:, 0]]
        tail_pos = ent2idx[batch[:, 1]]
        if head_pos.min() < 0 or tail_pos.min() < 0:
            raise ValueError("eval triple references an entity outside the "
                             "candidate set")
        if compute_filtered:
            hf, tf = build_filters(batch, filter_index, ent2idx,
                                   pad_width=filter_pad)
        else:
            hf = tf = empty_filters
        counts = _rank_batch(
            ent_emb, on_dev(head_pos), on_dev(tail_pos), rel_emb_table,
            on_dev(batch[:, 2]), n, on_dev(hf, torch.int32),
            on_dev(tf, torch.int32), rel_model=cfg.rel_model, tile=tile)
        # Counts stay on the device until the loop ends: one host sync.
        pending.append((counts, real))
        triples_seen.append(batch[:real])
        if log and (bi + 1) % max(1, n_batches // 5) == 0:
            log.info(f"[rank {bi + 1:,}/{n_batches:,}]")

    total_gt, total_geq, filt_gt, filt_geq = [], [], [], []
    for counts, real in pending:
        counts = {k: v.cpu().numpy()[:real] for k, v in counts.items()}
        total_gt.append(np.concatenate([counts["h_gt"], counts["t_gt"]]))
        total_geq.append(np.concatenate([counts["h_geq"], counts["t_geq"]]))
        if compute_filtered:
            filt_gt.append(np.concatenate([counts["h_gt"] - counts["h_fgt"],
                                           counts["t_gt"] - counts["t_fgt"]]))
            filt_geq.append(np.concatenate([counts["h_geq"] - counts["h_fgeq"],
                                            counts["t_geq"] - counts["t_fgeq"]]))

    def finish(gts, geqs):
        # Per-batch blocks are [heads...tails]; the breakdowns need the global
        # [all head corruption; all tail corruption] order.
        h = np.concatenate([np.split(x, 2)[0] for x in gts])
        t = np.concatenate([np.split(x, 2)[1] for x in gts])
        gh = np.concatenate([np.split(x, 2)[0] for x in geqs])
        gt_ = np.concatenate([np.split(x, 2)[1] for x in geqs])
        ranks = metrics.ranks_from_counts(
            torch.from_numpy(np.concatenate([h, t])),
            torch.from_numpy(np.concatenate([gh, gt_]))).numpy()
        rec = 1.0 / ranks
        hits = {k: float((ranks <= k).mean()) for k in HIT_POSITIONS}
        return float(rec.mean()), hits, rec

    mrr, hits, _ = finish(total_gt, total_geq)
    result = EvalResult(mrr=mrr, hits=hits)

    all_triples = np.concatenate(triples_seen)
    if compute_filtered:
        mrr_f, hits_f, rec_f = finish(filt_gt, filt_geq)
        result.mrr_filt, result.hits_filt = mrr_f, hits_f
        if new_entities is not None:
            mask = np.zeros(max_ent_id + 1, bool)
            mask[np.asarray(new_entities, np.int64)] = True
            sums, cnts = metrics.split_by_new_position(
                torch.from_numpy(all_triples), torch.from_numpy(rec_f),
                torch.from_numpy(mask))
            result.mrr_by_position = sums.numpy() / np.maximum(cnts.numpy(), 1.0)
        if rel_categories is not None:
            sums, cnts = metrics.split_by_category(
                torch.from_numpy(all_triples), torch.from_numpy(rec_f),
                torch.from_numpy(np.asarray(rel_categories)))
            result.mrr_by_category = sums.numpy() / np.maximum(cnts.numpy(), 1.0)

    if return_embeddings:
        result.ent_emb = ent_emb[:n].cpu().numpy()
        result.entities = entities
    return result
