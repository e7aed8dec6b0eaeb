"""Token-id constants (the port's copy of
`unpaired_image_captioning_tpu/constants.py`).

Two id conventions coexist in the reference and are preserved here:

1. **NMT convention** (reference `misc/OpenNMT-py-dalegebit/onmt/Constants.py:2-5`
   and `misc/constants.py:1-10`): PAD=0, UNK=1, BOS=2, EOS=3 with the literal
   word strings below.

2. **Caption convention** (reference `scripts/prepro_labels.py:46-110`,
   `misc/utils.py:49-66`): captions are encoded with word ids 1..V, id 0 is
   simultaneously PAD / implicit BOS / implicit EOS (decoding stops at the
   first 0), and UNK is the *last* vocabulary slot (id V, word '卍' for zh).
   Models therefore emit V+1 logits with index 0 = end-of-sequence.
"""

# --- NMT-side constants (onmt.Constants parity) ---
PAD = 0
UNK = 1
BOS = 2
EOS = 3

PAD_WORD = "<blank>"
UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"

# Sink token used by fertility-constrained attention variants
# (reference onmt/Models.py decoder upper-bound bookkeeping).
SINK_WORD = "<sink>"

# --- Caption-side constants ---
CAP_PAD = 0          # pad == implicit <bos>/<eos> in caption label tensors
ZH_UNK_WORD = "卍"   # reference scripts/prepro_labels.py UNK surface form
EN_UNK_WORD = "UNK"
