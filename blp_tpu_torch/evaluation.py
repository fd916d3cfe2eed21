"""Two-phase full-ranking link-prediction evaluation, on one device or with
the candidate table split over a mesh (parallel/eval_parallel.py).

Port of blp_tpu/evaluation.py. Phase 1 encodes every candidate entity into
an (Np, d) table in fixed-size chunks; phase 2 streams each eval batch
against the table with tie-aware rank counts and sparse filtered
corrections. Same semantics as the TPU package: raw and filtered
MRR/hits@{1,3,10}, head-corruption-first ordering of the reciprocals, the
self-tie, and the new-entity and relation-category breakdowns — without
materializing (B, N) scores. TransE ranks through K1 (ops/transe_rank.py:
the CUDA kernel on the card, its plain version on the CPU); the bilinear
scorers through the plain tiled stream (ops/ranking.py). Under a mesh each
rank encodes and counts its own block of the table and the int32 counts are
summed: the results equal the one-device evaluator's bit for bit. Phase
2's spans (`profiling.span`): `eval.ent2idx`, `eval.filters` (the width
pass), per batch `eval.batch_filters`, `eval.to_device` and
`eval.rank_batch`, then `eval.read_counts` and `eval.finish`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from blp_tpu_torch import metrics
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.datasets import CATEGORY_IDS
from blp_tpu_torch.data.filtering import FilterIndex, build_filters
from blp_tpu_torch.models import blp
from blp_tpu_torch.ops import ranking, transe_rank
from blp_tpu_torch.parallel import eval_parallel
from blp_tpu_torch.profiling import span
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
    get mask[:, 0] = 1 so no row is all-masked).

    Each chunk's description gather, padding and host-to-device copy run on
    the prefetch thread (data/prefetch.py), so they overlap the encode of
    the chunk before; `encode_batch` receives device tensors. The copies
    come from pinned memory with non_blocking=True, issued on the caller's
    current stream (the thread would otherwise use its own current stream
    and current device), so each encode is queued behind its chunk's copy
    and never reads a buffer mid-copy."""
    dev = torch.device(device)
    stream = None
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        stream = torch.cuda.current_stream(dev)
    n = len(entities)
    n_pad = _round_up(max(n, 1), pad_to)
    emb_batch_size = min(_round_up(emb_batch_size, chunk_multiple),
                         _round_up(max(n, 1), chunk_multiple))

    def host_chunks():
        for start in range(0, n, emb_batch_size):
            ids = entities[start:start + emb_batch_size]
            tok, mask = text_data.get_entity_descriptions(ids)
            if len(ids) < emb_batch_size:
                pad = emb_batch_size - len(ids)
                tok = np.pad(tok, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
                mask[len(ids):, 0] = 1.0
            yield {"tok": tok, "mask": mask}, len(ids)

    def place(item):
        chunk, real = item
        with torch.cuda.stream(stream):
            return prefetch.to_device(chunk, dev), real

    chunks, done = [], 0
    for ci, (chunk, real) in enumerate(prefetch.prefetch_to_device(
            host_chunks(), placement=place)):
        chunks.append(encode_batch(chunk["tok"], chunk["mask"])[:real])
        done += real
        if log and ci % 20 == 0:
            log.info(f"[encode {done:,}/{n:,}]")
    table = torch.zeros((n_pad, dim), dtype=torch.float32, device=dev)
    if chunks:
        table[:n] = torch.cat(chunks, dim=0)
    return table


def _rank_batch(table, head_pos, tail_pos, rel_table, rel_ids, num_valid: int,
                heads_filter, tails_filter, *, rel_model: str,
                tile: int, shard: eval_parallel.Shard | None = None) -> dict:
    """Raw + filtered rank counts for one eval batch, both directions, with
    the self-tie added. 'h_' prefixes head corruption, 't_' tail
    corruption; each value is (B,) int32. With `shard`, `table` is this
    rank's block and the counts are summed over the world."""
    rel_emb = rel_table[rel_ids]
    if shard is not None:
        c = eval_parallel.rank_counts_bidir(
            shard, table, head_pos, tail_pos, rel_emb, heads_filter,
            tails_filter, num_valid, rel_model=rel_model, tile=tile)
        return {k: v + 1 if k.endswith("_geq") else v for k, v in c.items()}
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
    `device` (default cuda), where `params` (whole, not sliced) must live.
    mesh: a DeviceMesh over the world (parallel/mesh.py) — every rank of it
    calls this with the same arguments, encodes and counts its block of the
    candidate table (parallel/eval_parallel.py) and gets the same result,
    equal to the one-device evaluator's bit for bit.
    """
    dev = resolve_device(device)
    if mesh is not None and not hasattr(mesh, "get_coordinate"):
        raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
    compute_filtered = filter_index is not None
    with span("eval.ent2idx"):
        max_ent_id = int(max(entities.max(), eval_triples[:, :2].max()))
        ent2idx = make_ent2idx(entities, max_ent_id)
    n = len(entities)
    # The tile is clamped to the candidates (under a mesh, to one rank's
    # share of them), so no pass streams a mostly padded table and every
    # rank's block holds real rows.
    share = n if mesh is None else -(-n // mesh.size())
    tile = min(tile, _round_up(max(share, 1), 256))
    pad_unit = tile if mesh is None else tile * mesh.size()
    n_pad = _round_up(n, pad_unit)
    shard = None if mesh is None else eval_parallel.Shard.of(mesh, n_pad)
    # The rows this process encodes and counts: the whole table, or its block.
    ids = entities if shard is None else shard.ids(entities)
    rows = n_pad if shard is None else shard.rows

    if ent_emb is None:
        if cfg.is_inductive:
            params_enc = blp.encode_view(params, cfg)

            def encode_batch(tok, mask):
                return blp.encode(params_enc, cfg, tok, mask, device=dev)

            # 4 keeps BERT sequence packing engaged (packing needs B % 4 == 0).
            ent_emb = build_entity_table(
                encode_batch, text_data, ids, emb_batch_size=emb_batch_size,
                dim=cfg.entity_dim, device=dev, pad_to=rows,
                chunk_multiple=4, log=log)
        else:
            ent_emb = torch.zeros((rows, cfg.entity_dim), device=dev)
            ent_emb[:len(ids)] = blp.encode_entity_ids(params, cfg, ids)
    else:
        if not isinstance(ent_emb, torch.Tensor):
            ent_emb = torch.from_numpy(np.array(ent_emb, np.float32))
        ent_emb = ent_emb.to(dev, torch.float32)
        if shard is not None:
            ent_emb = shard.pad(ent_emb[shard.offset:shard.offset + shard.rows])
        elif ent_emb.shape[0] != n_pad:
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
        with span("eval.filters"):
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
        with span("eval.batch_filters"):
            if compute_filtered:
                hf, tf = build_filters(batch, filter_index, ent2idx,
                                       pad_width=filter_pad)
            else:
                hf = tf = empty_filters
        with span("eval.to_device"):
            head_d, tail_d, rel_d = (on_dev(head_pos), on_dev(tail_pos),
                                     on_dev(batch[:, 2]))
            hf_d, tf_d = on_dev(hf, torch.int32), on_dev(tf, torch.int32)
        with span("eval.rank_batch"):
            counts = _rank_batch(
                ent_emb, head_d, tail_d, rel_emb_table, rel_d, n, hf_d, tf_d,
                rel_model=cfg.rel_model, tile=tile, shard=shard)
        # Counts stay on the device until the loop ends: one host sync.
        pending.append((counts, real))
        triples_seen.append(batch[:real])
        if log and (bi + 1) % max(1, n_batches // 5) == 0:
            log.info(f"[rank {bi + 1:,}/{n_batches:,}]")

    total_gt, total_geq, filt_gt, filt_geq = [], [], [], []
    with span("eval.read_counts"):
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

    with span("eval.finish"):
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
        if shard is not None:
            ent_emb = shard.whole(ent_emb)
        result.ent_emb = ent_emb[:n].cpu().numpy()
        result.entities = entities
    return result
