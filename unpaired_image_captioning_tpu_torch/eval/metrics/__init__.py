"""Caption metrics: host-side scorers with the COCO-caption API shape

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/__init__.py`,
host code copied as it is.
(`compute_score(gts, res) -> (overall, per_image)`).

Replaces the reference's vendored stacks (`coco-caption/pycocoevalcap/`,
`misc/cider/`, AI_Challenger zh twins) with pure-Python + C++ scorers —
the Java PTBTokenizer / METEOR jars the reference shells out to are not
even present in its tree (stripped blobs, .MISSING_LARGE_BLOBS).
"""

from .bleu import Bleu, corpus_bleu, sentence_bleu
from .cider import Cider, CiderD
from .rouge import Rouge
from .meteor import Meteor
from .spice import Spice
from .ter import Ter
