"""Filtered-setting candidate filters, precomputed into padded index arrays.

The reference walks a networkx MultiDiGraph per evaluation batch and builds
dense (B, N) boolean masks (reference: utils.py:46-83) — O(B*N) memory and a
CPU bottleneck at Wikidata5M scale. Here the known-true answers are indexed
once into hash maps keyed by (entity, relation) and each eval triple gets a
*sparse* list of filtered candidate positions, padded to a bucketed width.
The evaluator subtracts those few candidates from the tie-aware rank counts
instead of masking a dense score matrix — same metric, O(B*F) memory.
"""

from __future__ import annotations


import numpy as np


class _SortedMultiMap:
    """(key_entity, rel) -> sorted unique values, built fully vectorized:
    lexsort + duplicate drop + group offsets, queried by binary search. A
    Python loop over triples takes minutes at Wikidata5M scale (~20M filter
    triples); this builds in one numpy pass."""

    def __init__(self, keys_ent: np.ndarray, rels: np.ndarray,
                 values: np.ndarray):
        assert keys_ent.max(initial=0) < (1 << 31) and rels.max(initial=0) < (1 << 31)
        keys = (keys_ent.astype(np.int64) << 31) | rels.astype(np.int64)
        order = np.lexsort((values, keys))
        keys, values = keys[order], values[order]
        if len(keys):
            keep = np.concatenate([[True], (keys[1:] != keys[:-1]) |
                                   (values[1:] != values[:-1])])
            keys, values = keys[keep], values[keep]
        starts = np.concatenate([[True], keys[1:] != keys[:-1]]) if len(keys) \
            else np.zeros(0, bool)
        self._uniq = keys[starts] if len(keys) else np.zeros(0, np.int64)
        offs = np.flatnonzero(starts)
        self._offsets = np.concatenate([offs, [len(keys)]]).astype(np.int64) \
            if len(keys) else np.zeros(1, np.int64)
        self._values = values
        self._empty = np.zeros(0, np.int64)

    def get(self, ent: int, rel: int) -> np.ndarray:
        key = (int(ent) << 31) | int(rel)
        i = np.searchsorted(self._uniq, key)
        if i == len(self._uniq) or self._uniq[i] != key:
            return self._empty
        return self._values[self._offsets[i]:self._offsets[i + 1]]


class FilterIndex:
    """(head, rel) -> tails and (tail, rel) -> heads over the filter graph
    (all known-true triples)."""

    def __init__(self, triples: np.ndarray):
        """triples: (T, 3) [head, tail, rel]."""
        arr = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        self._tails_of = _SortedMultiMap(arr[:, 0], arr[:, 2], arr[:, 1])
        self._heads_of = _SortedMultiMap(arr[:, 1], arr[:, 2], arr[:, 0])

    def true_tails(self, head: int, rel: int) -> np.ndarray:
        return self._tails_of.get(head, rel)

    def true_heads(self, tail: int, rel: int) -> np.ndarray:
        return self._heads_of.get(tail, rel)


def _bucket(width: int, minimum: int = 8) -> int:
    """Round up to a power of two so jit sees few distinct shapes."""
    b = minimum
    while b < width:
        b *= 2
    return b


def build_filters(
    triples: np.ndarray,
    filter_index: FilterIndex,
    ent2idx: np.ndarray,
    pad_width: int | None = None,
):
    """Padded filtered-candidate positions for a batch of eval triples.

    For triple (h, t, r): head-prediction filters are other true heads h' of
    (?, r, t); tail-prediction filters other true tails t' of (h, r, ?) —
    excluding the triple's own entity, mapped to candidate-table positions,
    dropping entities outside the candidate set (reference: utils.py:63-83).

    Returns:
      heads_filter, tails_filter: (B, F) int32 position arrays, -1 padded.
    """
    rows_h: list[np.ndarray] = []
    rows_t: list[np.ndarray] = []
    n_ids = len(ent2idx)
    for h, t, r in np.asarray(triples, dtype=np.int64):
        true_h = filter_index.true_heads(int(t), int(r))
        true_h = true_h[(true_h != h) & (true_h < n_ids)]
        pos = ent2idx[true_h]
        rows_h.append(pos[pos >= 0])

        true_t = filter_index.true_tails(int(h), int(r))
        # Known answers outside the candidate id range can't be ranked anyway
        # (reference: utils.py:72-74 drops ent2idx == -1 entries).
        true_t = true_t[(true_t != t) & (true_t < n_ids)]
        pos = ent2idx[true_t]
        rows_t.append(pos[pos >= 0])

    width = max([1] + [len(x) for x in rows_h + rows_t])
    width = pad_width if pad_width is not None else _bucket(width)

    def pack(rows):
        out = np.full((len(rows), width), -1, np.int32)
        for i, row in enumerate(rows):
            out[i, : len(row)] = row[:width]
        return out

    return pack(rows_h), pack(rows_t)
