"""Offline tokenizers: WordPiece (BERT-compatible) and GloVe vocab lookup.

`WordPieceTokenizer` reproduces `transformers.BertTokenizer` semantics from a
local vocab.txt — basic tokenization (whitespace/control cleanup, punctuation
splitting, CJK isolation, optional lowercasing + accent stripping) followed by
greedy longest-match WordPiece with '##' continuations — so cached token
matrices are interchangeable with HF-produced ones (verified against
transformers in tests/test_tokenizers.py). No network, no framework imports.

`GloVeTokenizer` mirrors the reference's vocab-dict lookup tokenizer
(reference: data.py:303-334) on top of our hermetic `word_tokenize`.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from blp_tpu_torch.data.text import word_tokenize

UNK = "[UNK]"
CLS = "[CLS]"
SEP = "[SEP]"
PAD = "[PAD]"


def load_vocab(vocab_file: str) -> dict[str, int]:
    """One token per line -> id by line order (BERT vocab.txt format)."""
    vocab: dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII blocks treated as punctuation by BERT even where unicode disagrees
    # ($, +, <, =, >, ^, `, |, ~).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-style tokenizer from a local vocab file (no network)."""

    def __init__(self, vocab_file: str | None = None, *, vocab: dict[str, int] | None = None,
                 do_lower_case: bool = False, max_chars_per_word: int = 100):
        if vocab is None:
            if vocab_file is None:
                raise ValueError("Provide vocab_file or vocab")
            vocab = load_vocab(vocab_file)
        self.vocab = vocab
        self.vocab_file = vocab_file  # retained for the native fast path
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        for tok in (UNK, CLS, SEP, PAD):
            if tok not in vocab:
                raise ValueError(f"Vocab is missing special token {tok}")
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.pad_id = vocab[PAD]

    # -- basic tokenization ------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        # Isolate CJK characters.
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        tokens = "".join(spaced).split()

        out: list[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # Split on punctuation.
            cur: list[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # -- wordpiece ---------------------------------------------------------
    def _wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_chars_per_word:
            return [UNK]
        pieces: list[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for tok in self._basic_tokenize(text):
            out.extend(self._wordpiece(tok))
        return out

    # -- public API --------------------------------------------------------
    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = True) -> list[int]:
        """Token ids with [CLS]/[SEP], truncated to max_length total —
        matching HF `tokenizer.encode(text, max_length=...)` as used by the
        reference (data.py:244-246)."""
        ids = [self.vocab[t] for t in self.tokenize(text)]
        if add_special_tokens:
            if max_length is not None:
                ids = ids[: max_length - 2]
            return [self.cls_id] + ids + [self.sep_id]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def batch_encode(self, texts: list[str], max_length: int):
        """Fixed-shape padded batch: (B, max_length) ids + float mask, like
        `batch_encode_plus(..., pad_to_max_length=True)` (retrieval.py:61-68)."""
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            row = self.encode(text, max_length=max_length)
            ids[i, : len(row)] = row
        mask = (ids != self.pad_id).astype(np.float32)
        return ids, mask


class GloVeTokenizer:
    """Word-id lookup tokenizer over a GloVe vocabulary
    (reference: data.py:303-334). Pads with id 0; masks are (id > 0)."""

    def __init__(self, word2idx: dict[str, int] | str, uncased: bool = True):
        if isinstance(word2idx, str):
            import torch  # vocab dicts are saved in torch format for parity

            word2idx = torch.load(word2idx, weights_only=False)
        self.word2idx = word2idx
        self.uncased = uncased
        self.unk_id = word2idx[UNK]

    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = False) -> list[int]:
        if self.uncased:
            text = text.lower()
        ids = [self.word2idx.get(t, self.unk_id) for t in word_tokenize(text)]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def batch_encode(self, texts: list[str], max_length: int):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            row = self.encode(text, max_length=max_length)
            ids[i, : len(row)] = row
        mask = (ids > 0).astype(np.float32)
        return ids, mask
