"""English contraction expansion with ambiguity resolution (the port's copy
of `unpaired_image_captioning_tpu/utils/expander.py`).

Parity: reference `misc/expander/` (~1k LoC code + yaml rule tables +
named-entity tagging) used for caption post-processing in the pivot
pipeline. Structure mirrored here:

- `contractions.yaml` (the standard English contraction list incl. the
  compound forms) -> `TABLE` below for the unambiguous entries;
- `disambiguations*.yaml` (statistical (context-POS, contraction,
  following-POS) -> expansion tables) -> `expander_data.PAIR_DEFAULT`, a
  module GENERATED by tools/distill_expander.py: the argmax of the
  reference's own probability rows pooled over POS contexts (the rebuild
  has no runtime POS tagger). Function-word next-token cues stand in for
  the yaml's following-POS conditioning ('s "has" before past participles,
  'd "had"/"would"); when no cue fires, the distilled per-pair argmax
  decides, then generic suffix defaults.
"""

from __future__ import annotations

import re
from typing import List

from .expander_data import PAIR_DEFAULT

# unambiguous contractions (contractions.yaml coverage, incl. compounds)
TABLE = {
    "aren't": "are not", "can't": "cannot", "can't've": "cannot have",
    "'cause": "because", "could've": "could have",
    "couldn't": "could not", "couldn't've": "could not have",
    "didn't": "did not", "doesn't": "does not", "don't": "do not",
    "hadn't": "had not", "hadn't've": "had not have", "hasn't": "has not",
    "haven't": "have not", "he'd've": "he would have",
    "how'd": "how did", "how'd'y": "how do you", "how'll": "how will",
    "i'd've": "i would have", "i'm": "i am", "i've": "i have",
    "isn't": "is not", "it'd've": "it would have",
    "let's": "let us", "ma'am": "madam", "mayn't": "may not",
    "might've": "might have", "mightn't": "might not",
    "mightn't've": "might not have", "must've": "must have",
    "mustn't": "must not", "mustn't've": "must not have",
    "needn't": "need not", "needn't've": "need not have",
    "o'clock": "of the clock", "oughtn't": "ought not",
    "oughtn't've": "ought not have", "shan't": "shall not",
    "sha'n't": "shall not", "shan't've": "shall not have",
    "she'd've": "she would have", "should've": "should have",
    "shouldn't": "should not", "shouldn't've": "should not have",
    "so've": "so have", "that'd've": "that would have",
    "there'd've": "there would have", "they'd've": "they would have",
    "they're": "they are", "they've": "they have",
    "to've": "to have", "wasn't": "was not", "we'd've": "we would have",
    "we're": "we are", "we've": "we have", "weren't": "were not",
    "what're": "what are", "what've": "what have",
    "when've": "when have", "where'd": "where did",
    "where've": "where have", "who've": "who have",
    "why've": "why have", "will've": "will have", "won't": "will not",
    "won't've": "will not have", "would've": "would have",
    "wouldn't": "would not", "wouldn't've": "would not have",
    "y'all": "you all", "y'all'd": "you all would",
    "y'all'd've": "you all would have", "y'all're": "you all are",
    "y'all've": "you all have", "you're": "you are", "you've": "you have",
}

# ambiguous forms resolve through the DISTILLED reference tables
# (expander_data.PAIR_DEFAULT, generated from disambiguations*.yaml) —
# e.g. ("ain", "'t") -> "is not", ("he", "'ll") -> "he will"


def _pair_default(stem: str, suffix: str):
    """Distilled argmax expansion for (stem, suffix), lowercased to the
    caption pipeline's case convention; None when the reference tables
    have no (unique-max) row for the pair."""
    v = PAIR_DEFAULT.get((stem, suffix))
    return v.lower() if v is not None else None

# 's resolution: "is" before gerunds/adjectives/articles, "has" before past
# participles, possessive before plain nouns (the reference resolves with
# POS/NE tags; these function-word cues cover the caption domain)
_IS_CUES = re.compile(
    r"^(a|an|the|not|very|really|quite|so|too|going|being|been|"
    r"\w+ing|\w+ed)$")
_HAS_CUES = re.compile(r"^(been|got|gotten|had|done|made|taken|seen)$")
_WOULD_CUES = re.compile(r"^(like|love|prefer|rather|be|have|want|go|do)$")
# past participles that mark 'd = "had" (otherwise "would", the
# disambiguations.yaml argmax: e.g. he'd -> "he would" 0.571)
_HAD_CUES = re.compile(
    r"^(been|gone|done|seen|taken|made|left|lost|found|come|given|"
    r"known|grown|eaten|written|broken|fallen|\w+ed)$")

_PRONOUNS = {"he", "she", "it", "that", "this", "there", "what", "who",
             "where", "here", "one", "everything", "something", "nothing",
             "somebody", "someone", "everyone", "how", "when", "why"}


def expand_sentence(text: str) -> str:
    toks = text.split()
    out: List[str] = []
    i = 0
    while i < len(toks):
        raw = toks[i]
        low = raw.lower()
        nxt = toks[i + 1].lower() if i + 1 < len(toks) else ""
        if low in TABLE:
            out.extend(TABLE[low].split())
        elif low == "ain't":
            out.extend(_pair_default("ain", "'t").split())
        elif low.endswith("n't've") and low[:-6]:
            out.extend([low[:-6], "not", "have"])
        elif low.endswith("n't") and low[:-3]:
            out.extend([low[:-3], "not"])
        elif low.endswith("'d've"):
            out.extend([low[:-5], "would", "have"])
        elif low.endswith("'ll've"):
            out.extend([low[:-6], "will", "have"])
        elif low.endswith("'s"):
            stem = low[:-2]
            dist = _pair_default(stem, "'s")
            if _HAS_CUES.match(nxt):
                out.extend([stem, "has"])
            elif dist is not None:
                out.extend(dist.split())
            elif stem in _PRONOUNS or _IS_CUES.match(nxt):
                out.extend([stem, "is"])
            else:
                out.append(raw)  # possessive: keep
        elif low.endswith("'d"):
            stem = low[:-2]
            dist = _pair_default(stem, "'d")
            if _HAD_CUES.match(nxt) and not _WOULD_CUES.match(nxt):
                out.extend([stem, "had"])
            elif _WOULD_CUES.match(nxt):
                out.extend([stem, "would"])
            elif dist is not None:
                out.extend(dist.split())
            else:
                out.extend([stem, "would"])
        elif low.endswith("'re"):
            out.extend([low[:-3], "are"])
        elif low.endswith("'ve"):
            out.extend([low[:-3], "have"])
        elif low.endswith("'ll"):
            stem = low[:-3]
            dist = _pair_default(stem, "'ll")
            out.extend(dist.split() if dist is not None else [stem, "will"])
        elif low.endswith("'m"):
            out.extend([low[:-2], "am"])
        else:
            out.append(raw)
        i += 1
    return " ".join(out)
