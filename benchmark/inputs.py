"""Inputs and weights made from `--seed`, on the device, in a few large
calls.

- Weights: every leaf a family lists (`models/<family>.py` `leaves`), the
  normal ones from one draw, the uniform ones from another. Both the port
  and the reference get these tensors; neither makes weights of its own.
- Descriptions: an (entities, L) token matrix on the host, as the port's
  loader and evaluator read it (`TextStore`, the pattern of the port's
  `tools/w5m_e2e_eval.py` `SynthTextStore`): lengths from the traffic's
  share at the cap, ids drawn by rank from a Zipf law over the vocabulary,
  less the ranks of the words the configuration's pipeline drops.
- Graphs: uniform triples over the entities and relations, and for the
  rank traffic a known-true set whose answers per query follow a
  heavy-tailed count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.models.common import fold_seed

#: Sub-streams of a run's seed.
STREAM = {"weights": 1, "descriptions": 2, "triples": 3, "order": 4,
          "table": 5, "filters": 6, "check": 7, "train_key": 8}


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        fold_seed(seed, STREAM[stream]))


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(fold_seed(seed, STREAM[stream]))


def make_weights(leaves, seed: int, device) -> dict:
    """{path: f32 tensor} of `leaves` ((path, shape, init)), from the run's
    weight stream: one normal draw for every normal leaf (clipped at two
    standard deviations), one uniform draw for every uniform leaf."""
    gen = generator(seed, "weights", device)
    out = {}
    normal = [(p, s, i) for p, s, i in leaves if i[0] == "normal"]
    uniform = [(p, s, i) for p, s, i in leaves if i[0] == "uniform"]
    for group, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(math.prod(s) for _, s, _ in group)
        if not total:
            continue
        flat = draw(total, generator=gen, device=device)
        at = 0
        for path, shape, init in group:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if init[0] == "normal":
                out[path] = t.clamp_(-2.0, 2.0).mul_(init[1])
            else:
                out[path] = t.mul_(2.0 * init[1]).sub_(init[1])
    for path, shape, init in leaves:
        if init[0] == "ones":
            out[path] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, device=device)
    return {p: out[p] for p, _, _ in leaves}


def nest(flat: dict) -> dict:
    """{"a/b/c": t} as {"a": {"b": {"c": t}}}: the port's parameter tree."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


class TextStore:
    """The descriptions of every entity: an (N, L) int32 token matrix, each
    row zero past its length; `get_entity_descriptions` is the call the
    port's loader and evaluator make."""

    def __init__(self, tok: np.ndarray, lengths: np.ndarray):
        self.tok = tok
        self.lengths = lengths
        self.max_len = tok.shape[1]

    def get_entity_descriptions(self, ids: np.ndarray):
        tok = self.tok[ids]
        return tok, (tok > 0).astype(np.float32)


def zipf_cdf(ranks: int, exponent: float, device, dropped: int = 0) -> torch.Tensor:
    """The CDF over ranks 1..ranks of a Zipf law, rank r weighing r^-exponent,
    with the first `dropped` ranks weighing nothing: the words that remain
    keep the frequencies they have in the full text."""
    w = torch.arange(1, ranks + 1, dtype=torch.float64, device=device) ** -exponent
    w[:dropped] = 0.0
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def descriptions(n: int, max_len: int, tokens: dict, desc: dict, seed: int,
                 device, rows_a_block: int = 1 << 18) -> TextStore:
    """n descriptions of at most max_len tokens. A share `share_at_cap` of
    the rows is at the cap; the rest is uniform in [min_len, max_len - 1].
    Word ids are first_id + rank, rank ~ Zipf(exponent) over `ranks`,
    never one of the first `dropped_ranks` (words the pipeline drops); with
    `cls` and `sep` the row starts with cls and its last token is sep."""
    gen = generator(seed, "descriptions", device)
    u = torch.rand(n, generator=gen, device=device)
    short = desc["min_len"] + torch.floor(
        torch.rand(n, generator=gen, device=device)
        * (max_len - desc["min_len"])).long()
    lengths = torch.where(u < desc["share_at_cap"], max_len, short)
    dropped = int(tokens.get("dropped_ranks", 0))
    cdf = zipf_cdf(tokens["ranks"], desc["zipf_exponent"], device, dropped)
    col = torch.arange(max_len, device=device)
    tok = np.empty((n, max_len), np.int32)
    for r0 in range(0, n, rows_a_block):
        r1 = min(r0 + rows_a_block, n)
        draw = torch.rand((r1 - r0, max_len), generator=gen, device=device,
                          dtype=torch.float64)
        ids = torch.searchsorted(cdf, draw).clamp_(dropped, tokens["ranks"] - 1)
        ids += tokens["first_id"]
        ln = lengths[r0:r1, None]
        if "cls" in tokens:
            ids[:, 0] = tokens["cls"]
            ids = torch.where(col[None] == ln - 1, tokens["sep"], ids)
        ids = torch.where(col[None] < ln, ids, 0)
        tok[r0:r1] = ids.to(torch.int32).cpu().numpy()
    return TextStore(tok, lengths.cpu().numpy().astype(np.int32))


class TextGraph(TextStore):
    """Descriptions with a split's triples, read as the port's loader reads
    a TextGraphData: `triples` (T, 3) int32 [head, tail, rel],
    `num_triples`, `get_entity_descriptions`."""

    def __init__(self, store: TextStore, triples: np.ndarray):
        super().__init__(store.tok, store.lengths)
        self.triples = triples
        self.num_triples = len(triples)


def triples(n_triples: int, n_entities: int, n_relations: int, seed: int,
            device) -> np.ndarray:
    """(T, 3) int32 [head, tail, rel], uniform."""
    gen = generator(seed, "triples", device)
    ent = torch.randint(0, n_entities, (n_triples, 2), generator=gen,
                        device=device, dtype=torch.int32)
    rel = torch.randint(0, n_relations, (n_triples, 1), generator=gen,
                        device=device, dtype=torch.int32)
    return torch.cat([ent, rel], 1).cpu().numpy()


def known_true(test: np.ndarray, n_entities: int, alpha: float, cap: int,
               seed: int) -> np.ndarray:
    """The known-true triples the filtered ranking removes: the test
    triples, and for each of them c_t more tails of (h, r) and c_h more
    heads of (t, r). The counts are the T quantiles (i + 1/2) / T of a
    discrete Pareto law, c = min(floor(u^(-1/alpha)) - 1, cap): most
    queries have none, a few have hundreds. Every seed gets the same
    counts, dealt to the queries in its own order, so the filters' work
    does not change with the seed."""
    rng = numpy_rng(seed, "filters")
    t = len(test)
    grid = (np.arange(t) + 0.5) / t
    counts = np.minimum(np.floor(grid ** (-1.0 / alpha)) - 1, cap).astype(np.int64)
    extra = []
    for side in (1, 0):                          # more tails, then more heads
        c = rng.permutation(counts)
        rows = np.repeat(test, c, axis=0).astype(np.int64)
        rows[:, side] = rng.integers(0, n_entities, len(rows))
        extra.append(rows)
    return np.concatenate([test.astype(np.int64)] + extra)


def rank_table(n: int, n_pad: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n_pad, dim) f32 candidate table: n unit rows of random direction,
    zeros after them (the padded size the evaluator streams)."""
    gen = generator(seed, "table", device)
    table = torch.zeros((n_pad, dim), device=device)
    rows_a_block = 1 << 20
    for r0 in range(0, n, rows_a_block):
        r1 = min(r0 + rows_a_block, n)
        x = torch.randn((r1 - r0, dim), generator=gen, device=device)
        table[r0:r1] = x / x.norm(dim=1, keepdim=True)
    return table
