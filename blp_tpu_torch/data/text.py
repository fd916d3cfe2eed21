"""Self-contained text utilities: word tokenization and stop-word dropping.

The reference leans on NLTK (data.py:6-15, punkt + stopword corpora) which
needs downloaded corpora; this environment is offline and the data pipeline
should be hermetic anyway. `word_tokenize` here is a deterministic
Treebank-style tokenizer covering the behaviours the BLP pipeline relies on:
splitting punctuation off words, separating contractions, and keeping
hyphenated words together. `STOP_WORDS` is the standard English stop-word
list (public-domain word list, same set NLTK ships).
"""

from __future__ import annotations

import re
import string

# The classic 179-word English stop-word list.
STOP_WORDS = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your yours
yourself yourselves he him his himself she she's her hers herself it it's its
itself they them their theirs themselves what which who whom this that that'll
these those am is are was were be been being have has had having do does did
doing a an the and but if or because as until while of at by for with about
against between into through during before after above below to from up down
in out on off over under again further then once here there when where why how
all any both each few more most other some such no nor not only own same so
than too very s t can will just don don't should should've now d ll m o re ve
y ain aren aren't couldn couldn't didn didn't doesn doesn't hadn hadn't hasn
hasn't haven haven't isn isn't ma mightn mightn't mustn mustn't needn needn't
shan shan't shouldn shouldn't wasn wasn't weren weren't won won't wouldn
wouldn't
""".split())

#: Tokens dropped by the BOW/DKRL pipelines (reference: data.py:14-15 —
#: stopwords + punctuation).
DROPPED = STOP_WORDS | set(string.punctuation)

_CONTRACTIONS = re.compile(r"(?i)\b(\w+)(n't|'ll|'re|'ve|'s|'m|'d)\b")
_TOKEN_RE = re.compile(
    r"n't|'(?:ll|re|ve|s|m|d)\b"   # contraction suffixes (already space-split)
    r"|\d+(?:\.\d+)?"              # numbers incl. decimals
    r"|\w+(?:-\w+)*"               # words, hyphenated compounds stay joined
    r"|\.\.\."                     # ellipsis
    r"|[^\w\s]"                    # any other single punctuation mark
)


def word_tokenize(text: str) -> list[str]:
    """Deterministic Treebank-style word tokenizer.

    Splits standalone punctuation and trailing sentence periods into their own
    tokens, separates English contractions (don't -> do + n't), and keeps
    decimal numbers and hyphenated words intact.
    """
    text = _CONTRACTIONS.sub(r"\1 \2", text)
    return _TOKEN_RE.findall(text)


def remove_stopwords(text: str) -> str:
    """Drop stop words and punctuation tokens (reference: data.py:239-242,
    retrieval.py:34-38)."""
    return " ".join(t for t in word_tokenize(text) if t.lower() not in DROPPED)
