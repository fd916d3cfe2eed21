"""Graph + text datasets backed by packed numpy arrays.

File-format compatible with the reference's data directories
(reference: data.py:84-300):

    entities.txt / relations.txt      one name per line -> id by line order
    [ind-]{train,dev,test}.tsv        head <TAB> relation <TAB> tail
    relations-cat.txt                 relation <TAB> {1,many}-to-{1,many}
    entity2textlong.txt / entity2text.txt   entity <TAB> description
    {split}-ents.txt                  entity names per split

Copy of blp_tpu/data/datasets.py for the PyTorch port. The triple parse and
the ASCII WordPiece pass take the port's native C++ packer
(blp_tpu_torch/native) where it builds, under the TPU package's conditions,
and the pure-Python path otherwise; both give the same arrays. Everything
is packed into flat numpy arrays up front, the token
matrix is cached as .npz keyed by tokenizer settings (the same file name as
the TPU package's, with the same contents), and id maps are stored as JSON
next to the data (the torch `maps.pt` of a reference checkout is read
transparently for interop).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import os.path as osp
import tempfile

import numpy as np

from blp_tpu_torch import native
from blp_tpu_torch.data.text import remove_stopwords

CATEGORY_IDS = {"1-to-1": 0, "1-to-many": 1, "many-to-1": 2, "many-to-many": 3}


def file_to_ids(path: str) -> dict[str, int]:
    """One line -> one id, in line order (reference: data.py:19-32)."""
    out: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            out[line.strip()] = i
    return out


def load_maps(directory: str, write: bool = False):
    """Load (or create from entities.txt/relations.txt) the string->id maps.

    Creation order matches the reference exactly (data.py:100-111); existing
    maps.json or a reference checkout's maps.pt are reused so ids stay stable
    across splits.
    """
    json_path = osp.join(directory, "maps.json")
    pt_path = osp.join(directory, "maps.pt")
    if not write:
        if osp.exists(json_path):
            with open(json_path) as f:
                m = json.load(f)
            return m["ent_ids"], m["rel_ids"]
        if osp.exists(pt_path):
            import torch

            m = torch.load(pt_path, weights_only=False)
            return dict(m["ent_ids"]), dict(m["rel_ids"])
        raise FileNotFoundError(f"No maps file in {directory}; pass write_maps=True "
                                f"for the training split.")
    ent_ids = file_to_ids(osp.join(directory, "entities.txt"))
    rel_ids = file_to_ids(osp.join(directory, "relations.txt"))
    # Written to a file of its own and renamed over maps.json, so a process
    # reading the maps (another rank of the same run) never sees it half
    # written.
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".maps-", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump({"ent_ids": ent_ids, "rel_ids": rel_ids}, f)
    os.replace(tmp, json_path)
    return ent_ids, rel_ids


@dataclasses.dataclass
class GraphData:
    """A split's triples as an (T, 3) int32 array ordered [head, tail, rel]
    (reference: data.py:116-130)."""

    triples: np.ndarray                 # (T, 3) int32 [head, tail, rel]
    entities: np.ndarray                # unique entity ids in this split
    num_ents: int
    num_rels: int
    directory: str
    ent_ids: dict[str, int]
    rel_ids: dict[str, int]
    rel_categories: np.ndarray          # (num_all_rels,) int32
    has_rel_categories: bool

    @classmethod
    def load(cls, triples_file: str, write_maps: bool = False) -> "GraphData":
        directory = osp.dirname(triples_file)
        ent_ids, rel_ids = load_maps(directory, write=write_maps)

        triples = cls._parse_triples(triples_file, directory, ent_ids, rel_ids)

        entities = np.unique(triples[:, :2]) if len(triples) else np.zeros(0, np.int32)
        relations = np.unique(triples[:, 2]) if len(triples) else np.zeros(0, np.int32)

        rel_categories = np.zeros(len(rel_ids), np.int32)
        has_cats = False
        cat_file = osp.join(directory, "relations-cat.txt")
        if osp.exists(cat_file):
            with open(cat_file) as f:
                for line in f:
                    rel, cat = line.strip().split()
                    rel_categories[rel_ids[rel]] = CATEGORY_IDS[cat]
            has_cats = True

        return cls(
            triples=triples,
            entities=entities.astype(np.int32),
            num_ents=len(entities),
            num_rels=len(relations),
            directory=directory,
            ent_ids=ent_ids,
            rel_ids=rel_ids,
            rel_categories=rel_categories,
            has_rel_categories=has_cats,
        )

    @staticmethod
    def _parse_triples(triples_file, directory, ent_ids, rel_ids) -> np.ndarray:
        # Fast path: the mmap'd C++ parser, when the id maps come straight
        # from entities.txt/relations.txt line order.
        ents_path = osp.join(directory, "entities.txt")
        rels_path = osp.join(directory, "relations.txt")
        if osp.exists(ents_path) and osp.exists(rels_path) and native.available():
            packed = native.pack_triples(triples_file, ents_path, rels_path)
            if packed is not None:
                return packed

        heads, tails, rels = [], [], []
        with open(triples_file, encoding="utf-8") as f:
            for line in f:
                values = line.split()
                if not values:
                    continue
                # FB13/WN11 carry a 4th column; -1 rows are negatives for the
                # classification task and are skipped (reference: data.py:121-124).
                if len(values) > 3 and values[3] == "-1":
                    continue
                h, r, t = values[:3]
                heads.append(ent_ids[h])
                tails.append(ent_ids[t])
                rels.append(rel_ids[r])

        return np.stack([
            np.asarray(heads, np.int32),
            np.asarray(tails, np.int32),
            np.asarray(rels, np.int32),
        ], axis=1) if heads else np.zeros((0, 3), np.int32)

    @property
    def num_triples(self) -> int:
        return len(self.triples)


class TextGraphData(GraphData):
    """GraphData + per-entity token matrix.

    text_data is (num_all_entities, max_len + 1) int32; the last column holds
    the sequence length (reference: data.py:216-253). Cached to an .npz whose
    name encodes (max_len, drop_stopwords, tokenizer class + vocab hash) so
    different pipelines don't collide; a reference checkout's `text_data.pt`
    is accepted when `use_cached_text` is set, for byte-level interop.
    """

    text_data: np.ndarray

    @classmethod
    def load(cls, triples_file: str, *, tokenizer=None, max_len: int = 32,
             drop_stopwords: bool = False, write_maps: bool = False,
             use_cached_text: bool = False) -> "TextGraphData":
        self = GraphData.load.__func__(cls, triples_file, write_maps=write_maps)

        directory = self.directory
        if use_cached_text:
            pt = osp.join(directory, "text_data.pt")
            if osp.exists(pt):
                import torch

                self.text_data = torch.load(pt, weights_only=False).numpy().astype(np.int32)
                return self

        if tokenizer is None:
            raise ValueError("tokenizer required unless cached text exists")

        vocab_sig = hashlib.sha1(
            (type(tokenizer).__name__ + ":" + str(len(getattr(tokenizer, "vocab", None)
             or getattr(tokenizer, "word2idx", {})))).encode()).hexdigest()[:8]
        cache = osp.join(directory, f"text_{max_len}_{int(drop_stopwords)}_{vocab_sig}.npz")
        if osp.exists(cache):
            self.text_data = np.load(cache)["text_data"]
            return self

        ent_ids = self.ent_ids
        text_data = np.zeros((len(ent_ids), max_len + 1), np.int32)
        text_files = [osp.join(directory, name)
                      for name in ("entity2textlong.txt", "entity2text.txt")
                      if osp.exists(osp.join(directory, name))]

        # Native fast path: C++ WordPiece straight into the packed matrix
        # (ASCII rows; the Python pass below fills the non-ASCII ones). With
        # several text files a non-ASCII row of the first must not be filled
        # natively from the second (first file wins), so only one file.
        vocab_file = getattr(tokenizer, "vocab_file", None)
        if (vocab_file and not drop_stopwords and len(text_files) == 1
                and native.available()):
            native.wordpiece_encode_file(
                text_files[0], osp.join(directory, "entities.txt"),
                vocab_file, max_len=max_len,
                do_lower=getattr(tokenizer, "do_lower_case", False),
                text_data=text_data)

        read = set()
        # The Python pass fills what the native pass left empty. First file
        # wins (reference: data.py:221-236).
        for path in text_files:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    values = line.rstrip("\n").split("\t")
                    entity = values[0]
                    if entity not in ent_ids or entity in read:
                        continue
                    read.add(entity)
                    row = ent_ids[entity]
                    if text_data[row, -1] != 0:
                        continue  # packed natively
                    text = " ".join(values[1:])
                    if drop_stopwords:
                        text = remove_stopwords(text)
                    ids = tokenizer.encode(text, max_length=max_len)
                    n = min(len(ids), max_len)
                    text_data[row, :n] = ids[:n]
                    text_data[row, -1] = n

        if len(read) != len(ent_ids):
            raise ValueError(f"Read {len(read):,} descriptions but "
                             f"{len(ent_ids):,} were expected.")
        if text_data[:, -1].min() < 1:
            raise ValueError("Some entities have length-0 descriptions.")

        np.savez_compressed(cache, text_data=text_data)
        self.text_data = text_data
        return self

    @property
    def max_len(self) -> int:
        return self.text_data.shape[1] - 1

    def get_entity_descriptions(self, ent_ids: np.ndarray):
        """Token matrix + mask for a batch of entity ids, at the static
        dataset max_len (the reference truncates each batch to its longest
        description, data.py:270-282; fixed shapes avoid recompiles).

        Returns (text_tok (B, L), text_mask (B, L) float32).
        """
        rows = self.text_data[ent_ids]
        tok = rows[..., :-1]
        mask = (tok > 0).astype(np.float32)
        return tok, mask
