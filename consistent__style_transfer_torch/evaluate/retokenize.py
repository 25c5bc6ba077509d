"""Word-level regex tokenizer used by every evaluation metric (equivalent in
behavior to the DeepMoji-derived tokenizer the reference vendored,
``evaluate/auto/tokenizer.py:113-142``): recognizes URLs, emails, hashtags,
mentions, combined words (``red-haired``), contractions (``ca n't`` stays
split, ``don't`` -> ``don't``), titles, abbreviations, numbers, words, and
runs of identical symbols as single tokens; whitespace is discarded.

The style-transfer corpora are lowercased, space-separated English, so the
load-bearing cases are words / numbers / contractions / repeated punctuation;
the exotic classes are covered for input-compatibility.

The port's copy of the JAX package's ``evaluate/retokenize.py``, unchanged.
"""

from __future__ import annotations

import re

_WORD = r"[a-zA-Z]+"
_NUM = r"[0-9]+"
_COMB = rf"{_WORD}[-_]{_WORD}"
_CONTRACTION = rf"{_WORD}'{_WORD}"
_TITLE = r"(?:[Mm]r|[Mm]s|[Mm]rs|[Dd]r|[Pp]rof)\."
_ABBREV = r"\b(?<!\.)(?:[A-Za-z]\.){2,}"
_URL = r"(?:https?://|www\.)[^\s]+"
_EMAIL = r"\b[a-zA-Z0-9_.+-]+@[a-zA-Z0-9-]+\.[a-zA-Z0-9-.]+\b"
_HASHTAG = r"#[a-zA-Z0-9_]+"
_MENTION = r"@[a-zA-Z0-9_]+"
_HEART = r"(?:<+/?3+)+"
# runs of one repeated symbol ("!!!" -> one token, "?!" -> two tokens)
_SYMBOL_RUN = r"([^\w\s])\1*"

_PATTERN = re.compile(
    "|".join(
        [
            _URL,
            _EMAIL,
            _COMB,
            _HASHTAG,
            _MENTION,
            _HEART,
            _CONTRACTION,
            _TITLE,
            _ABBREV,
            _NUM,
            _WORD,
            _SYMBOL_RUN,
        ]
    )
)


def tokenize(text: str) -> list[str]:
    return [m.group(0) for m in _PATTERN.finditer(text) if m.group(0).strip()]
