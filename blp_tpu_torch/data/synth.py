"""Synthetic dataset generator (reference file format).

Produces a small knowledge graph with entity descriptions, a WordPiece-style
vocab, and inductive splits — used by tests and bench.py since this
environment ships no real datasets. Deterministic given the seed.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

_WORDS = [
    "protein", "enzyme", "cell", "organ", "tissue", "disease", "virus",
    "treats", "binds", "acts", "signal", "receptor", "acid", "process",
    "system", "function", "structure", "group", "human", "animal", "plant",
    "causes", "finding", "result", "measure", "clinical", "body", "blood",
    "brain", "heart", "gene", "molecule", "substance", "drug", "therapy",
]


def write_synth_dataset(
    directory: str,
    *,
    num_entities: int = 60,
    num_relations: int = 5,
    num_triples: int = 400,
    desc_words: tuple[int, int] = (4, 12),
    inductive_frac: float = 0.2,
    seed: int = 0,
    num_types: int = 0,
    distinct_type_pairs: bool = False,
) -> str:
    """Write a synthetic dataset under `directory` and return it.

    Emits: entities.txt, relations.txt, train/dev/test.tsv (transductive
    split of edges), ind-train/dev/test.tsv + {split}-ents.txt (inductive
    entity split), entity2text.txt, vocab.txt, relations-cat.txt, and
    {split}-ents-class.txt (node-classification labels).

    num_types > 0 switches to a LEARNABLE task: each entity gets a type,
    its description leads with that type's word, and relation r only links
    (head_type_r -> tail_type_r) pairs. A text encoder that reads the type
    word can then rank type-consistent candidates above the rest, so test
    MRR must clear the random baseline by a wide margin — used by the
    learnability tests. Node-class labels become the type.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    types = None
    # Relation r links only heads of type ht[r] to tails of type tt[r].
    if num_types > 0:
        if num_types > min(num_entities, num_relations):
            raise ValueError(
                f"num_types={num_types} needs num_entities and num_relations "
                f"to be at least that large")
        types = rng.integers(num_types, size=num_entities)
        # Deterministically inhabit every type (entity i < num_types gets
        # type i) — a random reassignment loop can re-empty a type it
        # already fixed.
        types[np.arange(num_types)] = np.arange(num_types)
        rel_head_type = rng.integers(num_types, size=num_relations)
        rel_tail_type = rng.integers(num_types, size=num_relations)
        # Every type heads at least one relation, so the connectivity pass
        # below can always attach an isolated entity as a head.
        rel_head_type[np.arange(num_types)] = np.arange(num_types)
        if distinct_type_pairs:
            # ht[r] != tt[r]: no within-type relations. TransE geometry then
            # has a cycle-free solution (type centroids + r as the centroid
            # difference), making high absolute MRR provably reachable —
            # used by the strict learnability tests.
            same = rel_head_type == rel_tail_type
            rel_tail_type[same] = (rel_head_type[same] + 1) % num_types
        by_type = [np.flatnonzero(types == c) for c in range(num_types)]

    ents = [f"ent_{i:04d}" for i in range(num_entities)]
    rels = [f"rel_{i}" for i in range(num_relations)]
    with open(osp.join(directory, "entities.txt"), "w") as f:
        f.write("\n".join(ents) + "\n")
    with open(osp.join(directory, "relations.txt"), "w") as f:
        f.write("\n".join(rels) + "\n")

    if types is None:
        # Random connected-ish multigraph: ring backbone + random edges.
        edges = set()
        for i in range(num_entities):
            edges.add((i, (i + 1) % num_entities, int(rng.integers(num_relations))))
        while len(edges) < num_triples:
            h, t = rng.integers(num_entities, size=2)
            if h == t:
                continue
            edges.add((int(h), int(t), int(rng.integers(num_relations))))
    else:
        # Type-consistent edges only. A connectivity pass then attaches any
        # entity the random sampling left isolated (as the head of its
        # type's own relation), so every entity has at least one edge.
        edges = set()
        tries = 0
        while len(edges) < num_triples and tries < num_triples * 50:
            tries += 1
            r = int(rng.integers(num_relations))
            hs = by_type[rel_head_type[r]]
            ts_ = by_type[rel_tail_type[r]]
            h = int(hs[rng.integers(len(hs))])
            t = int(ts_[rng.integers(len(ts_))])
            if h != t:
                edges.add((h, t, r))
        if len(edges) < num_triples:
            import warnings
            warnings.warn(f"typed graph saturated at {len(edges)} edges "
                          f"(< requested {num_triples})")
        touched = np.zeros(num_entities, bool)
        for h, t, _ in edges:
            touched[h] = touched[t] = True
        for e in np.flatnonzero(~touched):
            r = int(types[e])  # rel_head_type[r] == types[e] by construction
            pool = by_type[rel_tail_type[r]]
            pool = pool[pool != e]
            if len(pool) == 0:
                raise ValueError(
                    f"cannot connect entity {e}: type {rel_tail_type[r]} has "
                    f"no other member; use more entities per type")
            edges.add((int(e), int(pool[rng.integers(len(pool))]), r))
    edges = sorted(edges)
    rng.shuffle(edges)

    # Descriptions + vocab. In typed mode the first word names the type;
    # beyond the natural word list, synthetic type tokens are generated (and
    # added to the vocab below) so graphs can have thousands of types.
    if types is None:
        type_words = []
    elif num_types <= len(_WORDS):
        type_words = _WORDS[:num_types]
    else:
        type_words = [f"type{i:05d}" for i in range(num_types)]
    with open(osp.join(directory, "entity2text.txt"), "w") as f:
        for i, e in enumerate(ents):
            n = int(rng.integers(desc_words[0], desc_words[1] + 1))
            words = [_WORDS[int(w)] for w in rng.integers(len(_WORDS), size=n)]
            if types is not None:
                words = [type_words[types[i]]] + words
            f.write(f"{e}\t{' '.join(words)}.\n")

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + _WORDS
    vocab += [w for w in type_words if w not in _WORDS]
    # A few wordpieces to exercise the continuation path.
    vocab += ["##s", "##ing", "pro", "##tein"]
    with open(osp.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")

    # Transductive split of edges 80/10/10.
    n = len(edges)
    cut1, cut2 = int(0.8 * n), int(0.9 * n)
    for name, sl in (("train", slice(0, cut1)), ("dev", slice(cut1, cut2)),
                     ("test", slice(cut2, n))):
        with open(osp.join(directory, f"{name}.tsv"), "w") as f:
            for h, t, r in edges[sl]:
                f.write(f"{ents[h]}\t{rels[r]}\t{ents[t]}\n")

    # Inductive split: hold out entities; their incident edges form dev/test.
    num_drop = max(2, int(num_entities * inductive_frac))
    dropped = list(rng.choice(num_entities, size=num_drop, replace=False))
    test_ents = set(int(x) for x in dropped[: num_drop // 2])
    dev_ents = set(int(x) for x in dropped[num_drop // 2:])
    held = test_ents | dev_ents

    def bucket(edge):
        h, t, _ = edge
        if h in test_ents or t in test_ents:
            return "test"
        if h in dev_ents or t in dev_ents:
            return "dev"
        return "train"

    buckets = {"train": [], "dev": [], "test": []}
    for e in edges:
        buckets[bucket(e)].append(e)
    # Keep the train graph free of orphaned rows: every entity in ind-train
    # must appear there; entities only seen in held-out edges are fine.
    for name in ("train", "dev", "test"):
        with open(osp.join(directory, f"ind-{name}.tsv"), "w") as f:
            for h, t, r in buckets[name]:
                f.write(f"{ents[h]}\t{rels[r]}\t{ents[t]}\n")
    train_ents = sorted({x for h, t, _ in buckets["train"] for x in (h, t)})
    for name, eset in (("train", train_ents), ("dev", sorted(dev_ents)),
                       ("test", sorted(test_ents))):
        with open(osp.join(directory, f"{name}-ents.txt"), "w") as f:
            f.write("\n".join(ents[i] for i in eset) + "\n")

    # Relation categories: deterministic assignment.
    cats = ["1-to-1", "1-to-many", "many-to-1", "many-to-many"]
    with open(osp.join(directory, "relations-cat.txt"), "w") as f:
        for i, r in enumerate(rels):
            f.write(f"{r}\t{cats[i % 4]}\n")

    # Node-classification labels: the type in typed mode (learnable), else
    # 3 classes by entity id band.
    for name, eset in (("train", train_ents), ("dev", sorted(dev_ents)),
                       ("test", sorted(test_ents))):
        with open(osp.join(directory, f"{name}-ents-class.txt"), "w") as f:
            for i in eset:
                label = int(types[i]) if types is not None else i % 3
                f.write(f"{ents[i]}\tclass_{label}\n")

    return directory


def write_tiny_glove(path_prefix: str, vocab_file: str, *, dim: int = 300,
                     seed: int = 0) -> str:
    """Write a tiny GloVe pair (`<prefix>.pt` tensor + `<prefix>-maps.pt`
    word->id dict, the reference's torch format, data.py:303-334) built from
    a dataset vocab. Id 0 is reserved for padding (masks are id > 0); the
    dict includes '[UNK]'. Used by tests and offline runs of glove-* models,
    which this zero-egress environment cannot download real GloVe for."""
    import torch

    words = [w for w in open(vocab_file).read().splitlines() if w]
    w2i = {"[UNK]": 1}
    for w in words:
        if w != "[PAD]" and w not in w2i:
            w2i[w] = len(w2i) + 1
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((max(w2i.values()) + 1, dim)).astype(np.float32)
    torch.save(torch.from_numpy(table * 0.1), f"{path_prefix}.pt")
    torch.save(w2i, f"{path_prefix}-maps.pt")
    return f"{path_prefix}.pt"
