"""Offline dataset tooling: inductive split generation, GloVe conversion,
relation categorization, DBpedia description harvesting.

Capability parity with the reference's data/utils.py CLI, re-implemented on
plain dict adjacency (no networkx dependency in the hot loop — the reference's
`nx.MultiDiGraph` walks dominate split-generation time at Wikidata5M scale).
Copy of blp_tpu/data/splits.py for the PyTorch port: host code whose files
are byte-identical to the TPU package's for the same inputs and seed.

CLI:
    python -m blp_tpu_torch.data.splits drop_entities --file data/x/all-triples.tsv
    python -m blp_tpu_torch.data.splits load_embs --file glove.6B.300d.txt
    python -m blp_tpu_torch.data.splits categorize --file data/x/train.tsv
    python -m blp_tpu_torch.data.splits get_ranking_descriptions --file run.run \
        --dbp_file dump.nt --redirects_file redirects.nt
"""

from __future__ import annotations

import os.path as osp
import random
import re
import sys
from argparse import ArgumentParser
from collections import Counter, defaultdict


def parse_triples(triples_file: str):
    """(head, tail, rel) string triples + per-relation counts
    (reference: data/utils.py:12-23)."""
    triples = []
    rel_counts: Counter = Counter()
    with open(triples_file, encoding="utf-8") as f:
        for line in f:
            head, rel, tail = line.split()
            triples.append((head, tail, rel))
            rel_counts[rel] += 1
    return triples, rel_counts


class MultiGraph:
    """Directed multigraph on string nodes with O(1) neighbor sets and
    per-pair edge lists — the operations the split generator needs."""

    def __init__(self, triples):
        self.pair_edges: dict[tuple, list[str]] = defaultdict(list)
        self.neighbors: dict[str, set] = defaultdict(set)
        for h, t, r in triples:
            self.pair_edges[(h, t)].append(r)
            self.neighbors[h].add(t)
            self.neighbors[t].add(h)

    @property
    def nodes(self):
        return self.neighbors.keys()

    def num_edges(self) -> int:
        return sum(len(v) for v in self.pair_edges.values())

    def edges_between(self, u, v):
        return self.pair_edges.get((u, v), ())

    def remove_node(self, node):
        for m in list(self.neighbors[node]):
            self.pair_edges.pop((node, m), None)
            self.pair_edges.pop((m, node), None)
            if m != node:
                self.neighbors[m].discard(node)
        del self.neighbors[node]

    def edges(self):
        for (h, t), rels in self.pair_edges.items():
            for r in rels:
                yield h, t, r


def get_safely_removed_edges(graph: MultiGraph, node, rel_counts,
                             min_edges_left: int = 100):
    """Edges removed by deleting `node`, or None if any neighbor would be
    orphaned or any relation would fall below min_edges_left
    (reference: data/utils.py:36-77)."""
    neighbors = set(graph.neighbors[node])
    removed_rel_counts: Counter = Counter()
    removed_edges = []

    for m in neighbors:
        # m must keep >2 neighbors (node, and potentially itself) to survive.
        if len(graph.neighbors[m]) <= 2:
            return None
        pair = (node, m)
        for _ in range(2):
            for rel in graph.edges_between(*pair):
                edges_left = rel_counts[rel] - removed_rel_counts[rel]
                if edges_left >= min_edges_left:
                    removed_rel_counts[rel] += 1
                    removed_edges.append((pair[0], pair[1], rel))
                else:
                    return None
            if node == m:  # don't count self-loops twice
                break
            pair = (pair[1], pair[0])

    return removed_edges, removed_rel_counts


def read_entity_types(entity2type_file: str):
    type2entities = defaultdict(set)
    with open(entity2type_file, encoding="utf-8") as f:
        for line in f:
            entity, label = line.strip().split()
            type2entities[label].add(entity)
    return dict(type2entities)


def drop_entities(triples_file: str, *, train_size: float = 0.8,
                  valid_size: float = 0.1, test_size: float = 0.1,
                  seed: int = 0, types_file: str | None = None,
                  min_edges_left: int = 100):
    """Create inductive train/dev/test splits by dropping entities such that
    the training graph keeps no orphan nodes and every relation keeps at least
    `min_edges_left` training edges; the first-dropped slice becomes test so
    dev triples never touch test entities (reference: data/utils.py:80-199)."""
    splits_sum = train_size + valid_size + test_size
    if splits_sum < 0 or splits_sum > 1:
        raise ValueError("Sum of split sizes must be in (0, 1].")

    use_types = types_file is not None
    if use_types:
        type2entities = read_entity_types(types_file)
        types = list(type2entities)

    rng = random.Random(seed)
    triples, rel_counts = parse_triples(triples_file)
    graph = MultiGraph(triples)
    original_num_edges = graph.num_edges()
    original_num_nodes = len(graph.neighbors)
    print(f"Loaded graph with {original_num_nodes:,} entities and "
          f"{original_num_edges:,} edges")

    num_to_drop = int(original_num_nodes * (1 - train_size))
    num_val = int(original_num_nodes * valid_size)
    num_test = int(original_num_nodes * test_size)

    dropped_entities = []
    dropped_edges: dict[str, list] = {}
    node_list = list(graph.nodes)
    print(f"Removing {num_to_drop:,} entities...")
    attempts = 0
    while len(dropped_entities) < num_to_drop:
        attempts += 1
        if attempts > 100 * max(num_to_drop, 1):
            raise RuntimeError("Could not find enough safely-removable "
                               "entities; graph too sparse for requested split")
        if use_types:
            weights = [len(type2entities[t]) - 1 for t in types]
            rand_type = rng.choices(types, weights, k=1)[0]
            rand_ent = rng.choice(sorted(type2entities[rand_type]))
        else:
            rand_ent = rng.choice(node_list)
            if rand_ent not in graph.neighbors:
                continue

        removed = get_safely_removed_edges(graph, rand_ent, rel_counts,
                                           min_edges_left)
        if removed is None:
            continue
        removed_edges, removed_counts = removed
        dropped_edges[rand_ent] = removed_edges
        graph.remove_node(rand_ent)
        dropped_entities.append(rand_ent)
        rel_counts.subtract(removed_counts)
        if use_types:
            type2entities[rand_type].discard(rand_ent)

    # Invariants (reference: data/utils.py:144-169).
    assert all(graph.neighbors[n] for n in graph.nodes), "isolated node left"
    num_removed = sum(map(len, dropped_edges.values()))
    assert num_removed + graph.num_edges() == original_num_edges

    test_ents = set(dropped_entities[:num_test])
    val_ents = set(dropped_entities[num_test : num_test + num_val])
    train_ents = set(graph.nodes)
    assert not (train_ents & val_ents)
    assert not (train_ents & test_ents)
    assert not (val_ents & test_ents)
    val_graph_nodes = {x for e in val_ents for h, t, _ in dropped_edges[e]
                       for x in (h, t)}
    assert not (val_graph_nodes & test_ents), \
        "dev triples touch test entities"

    dirname = osp.dirname(triples_file)
    for entity_set, name in ((train_ents, "train"), (val_ents, "dev"),
                             (test_ents, "test")):
        with open(osp.join(dirname, f"{name}-ents.txt"), "w") as f:
            f.write("\n".join(sorted(entity_set)))
        if name == "train":
            continue
        with open(osp.join(dirname, f"ind-{name}.tsv"), "w") as f:
            for entity in sorted(entity_set):
                for h, t, r in dropped_edges[entity]:
                    f.write(f"{h}\t{r}\t{t}\n")

    with open(osp.join(dirname, "ind-train.tsv"), "w") as f:
        for h, t, r in graph.edges():
            f.write(f"{h}\t{r}\t{t}\n")

    print(f"Dropped {len(val_ents):,} entities for validation and "
          f"{len(test_ents):,} for test; {len(train_ents):,} remain for "
          f"training. Files in {dirname}/")
    return train_ents, val_ents, test_ents


def load_embeddings(embs_file: str):
    """GloVe text file -> <name>.pt tensor + <name>-maps.pt vocab dict, with a
    mean-vector [UNK] row appended (reference: data/utils.py:202-234). Torch
    formats kept for interop with reference checkouts."""
    import numpy as np
    import torch

    filename, _ = osp.splitext(embs_file)
    word2idx = {}
    vectors = []
    with open(embs_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            word, *embedding = line.rstrip("\n").split(" ")
            word2idx[word] = i
            vectors.append(np.asarray(embedding, np.float32))
    mat = np.stack(vectors)
    mat = np.concatenate([mat, mat.mean(0, keepdims=True)])
    word2idx["[UNK]"] = len(word2idx)
    torch.save(torch.from_numpy(mat), f"{filename}.pt")
    torch.save(word2idx, f"{filename}-maps.pt")
    print(f"Saved {mat.shape} embeddings to {filename}.pt")


def categorize_relations(triples_file: str, threshold: float = 1.5):
    """Label each relation {1,many}-to-{1,many} by average head/tail fan-out
    and write relations-cat.txt (reference: data/utils.py:237-301)."""
    triples, _ = parse_triples(triples_file)
    heads_per_tail = defaultdict(Counter)   # rel -> tail -> #heads
    tails_per_head = defaultdict(Counter)   # rel -> head -> #tails
    for h, t, r in triples:
        heads_per_tail[r][t] += 1
        tails_per_head[r][h] += 1

    rel2category = {}
    for rel in heads_per_tail:
        head_counts = heads_per_tail[rel].values()
        tail_counts = tails_per_head[rel].values()
        head_avg = sum(head_counts) / len(head_counts)
        tail_avg = sum(tail_counts) / len(tail_counts)
        head_cat = "1" if head_avg < threshold else "many"
        tail_cat = "1" if tail_avg < threshold else "many"
        rel2category[rel] = f"{head_cat}-to-{tail_cat}"

    cat_counts = Counter(rel2category.values())
    print("Relation category statistics:")
    for category, count in cat_counts.items():
        print(f"{category:13} {count:3}  {100 * count / len(rel2category):4.1f}%")

    out = osp.join(osp.dirname(triples_file), "relations-cat.txt")
    with open(out, "w") as f:
        for relation, category in rel2category.items():
            f.write(f"{relation}\t{category}\n")
    print(f"Saved relation categories to {out}")
    return rel2category


_N3_COMMENT = re.compile(
    r"^<(?P<uri>[^>]+)>\s+<[^>]*(?:comment|abstract)[^>]*>\s+"
    r'"(?P<text>(?:[^"\\]|\\.)*)"')


def get_ranking_descriptions(run_file: str, dbpedia_file: str,
                             redirects_file: str | None = None):
    """Extract rdfs:comment descriptions for the entities of a TREC run from
    a DBpedia N-Triples dump (reference: data/utils.py:304-366). Implemented
    with a line regex — the dumps are line-oriented n3 and this environment
    has no rdflib."""
    entities = set()
    with open(run_file, encoding="utf-8") as f:
        for line in f:
            entities.add(line.split()[2])

    dbpedia_ns = "http://dbpedia.org/resource/"
    dbpedia_prefix = "dbpedia:"

    redir2entities = defaultdict(set)
    if redirects_file and osp.exists(redirects_file):
        with open(redirects_file, encoding="utf-8") as f:
            for line in f:
                values = line.strip().split()
                if len(values) < 3:
                    continue
                norm = values[0].replace(dbpedia_ns, dbpedia_prefix, 1)
                if norm in entities:
                    redir2entities[values[2]].add(norm)

    basename = osp.splitext(osp.basename(run_file))[0]
    output_file = osp.join(osp.dirname(run_file), basename + "-descriptions.txt")
    missing_file = osp.join(osp.dirname(run_file), basename + "-missing.txt")

    read_entities = set()
    with open(dbpedia_file, encoding="utf-8") as f, \
            open(output_file, "w", encoding="utf-8") as out:
        for line in f:
            m = _N3_COMMENT.match(line)
            if not m:
                continue
            uri, text = m.group("uri"), m.group("text")
            text = text.encode().decode("unicode_escape", errors="ignore")
            norm = f"<{uri.replace(dbpedia_ns, dbpedia_prefix, 1)}>"
            if norm in entities and norm not in read_entities:
                read_entities.add(norm)
                out.write(f"{norm}\t{text}\n")
            n3 = f"<{uri}>"
            for entity in redir2entities.get(n3, ()):
                if entity not in read_entities:
                    read_entities.add(entity)
                    out.write(f"{entity}\t{text}\n")
            if len(read_entities) == len(entities):
                break

    with open(missing_file, "w") as f:
        for entity in sorted(entities - read_entities):
            f.write(f"{entity}\n")
    print(f"Retrieved {len(read_entities):,}/{len(entities):,} descriptions "
          f"-> {output_file}")


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("command", choices=["drop_entities", "load_embs",
                                            "categorize",
                                            "get_ranking_descriptions"])
    parser.add_argument("--file", help="Input file")
    parser.add_argument("--dbp_file")
    parser.add_argument("--redirects_file")
    parser.add_argument("--types_file", default=None)
    parser.add_argument("--train_size", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--min_edges_left", type=int, default=100)
    args = parser.parse_args(argv)

    if args.command == "drop_entities":
        drop_entities(args.file, train_size=args.train_size, seed=args.seed,
                      types_file=args.types_file,
                      min_edges_left=args.min_edges_left)
    elif args.command == "load_embs":
        load_embeddings(args.file)
    elif args.command == "categorize":
        categorize_relations(args.file)
    elif args.command == "get_ranking_descriptions":
        if not args.file or not args.dbp_file:
            raise ValueError("--file and --dbp_file required")
        get_ranking_descriptions(args.file, args.dbp_file, args.redirects_file)


if __name__ == "__main__":
    sys.exit(main())
