"""Caption model families + NMT seq2seq (counterpart of
`unpaired_image_captioning_tpu/models/__init__.py`).

`setup(cfg)` is the caption-model factory; it builds on the card unless
`device=` names another. The port has the
denseatt, stackatt and transformer families so far; the others are ROADMAP
A10.
"""

from __future__ import annotations

from .att import AttModel, DenseAttModel, StackAttModel
from .base import CaptionDecoder, Features
from .transformer import TransformerModel

_REGISTRY = {
    "stackatt": StackAttModel,
    "denseatt": DenseAttModel,
    "transformer": TransformerModel,
}

# families of the JAX factory that the port does not have yet
_NOT_PORTED = ("fc", "att2in", "att2in2", "att2all2", "adaatt", "adaattmo",
               "topdown", "stackcap", "show_tell",
               "show_attend_tell", "all_img")


def setup(cfg, *, device="cuda") -> CaptionDecoder:
    """Build a caption model from config, on the card unless `device` names
    another (with no card, the default raises)."""
    name = cfg.caption_model
    if name in _REGISTRY:
        return _REGISTRY[name].from_config(cfg, device=device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"caption model {name!r} is not ported yet (ROADMAP A10)")
    raise ValueError(f"Caption model not supported: {name}")


__all__ = ["AttModel", "CaptionDecoder", "DenseAttModel", "Features",
           "StackAttModel", "TransformerModel", "setup"]
