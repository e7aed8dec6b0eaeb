"""Caption model families + NMT seq2seq (counterpart of
`unpaired_image_captioning_tpu/models/__init__.py`).

`setup(cfg)` is the caption-model factory over the JAX package's 14 keys;
it builds on the card unless `device=` names another.
"""

from __future__ import annotations

from .att import (AdaAttModel, AdaAttMOModel, Att2all2Model, Att2in2Model,
                  Att2inModel, AttModel, DenseAttModel, ShowAttendTellModel,
                  StackAttModel, TopDownModel)
from .base import CaptionDecoder, Features
from .fc import FCModel
from .show_tell import AllImgModel, ShowTellModel
from .stackcap import StackCapModel
from .transformer import TransformerModel

_REGISTRY = {
    # 'fc' is the reference's FCModel_NMT (dropout inside the cell)
    "fc": FCModel,
    "att2in": Att2inModel,
    "att2in2": Att2in2Model,
    "att2all2": Att2all2Model,
    "adaatt": AdaAttModel,
    "adaattmo": AdaAttMOModel,
    "topdown": TopDownModel,
    "stackatt": StackAttModel,
    "denseatt": DenseAttModel,
    "transformer": TransformerModel,
    "stackcap": StackCapModel,
    # present but unwired in the reference factory; wired here as in JAX
    "show_tell": ShowTellModel,
    "show_attend_tell": ShowAttendTellModel,
    "all_img": AllImgModel,
}


def setup(cfg, *, device="cuda") -> CaptionDecoder:
    """Build a caption model from config, on the card unless `device` names
    another (with no card, the default raises)."""
    name = cfg.caption_model
    if name not in _REGISTRY:
        raise ValueError(f"Caption model not supported: {name}")
    return _REGISTRY[name].from_config(cfg, device=device)


__all__ = ["AdaAttMOModel", "AdaAttModel", "AllImgModel", "Att2all2Model",
           "Att2in2Model", "Att2inModel", "AttModel", "CaptionDecoder",
           "DenseAttModel", "FCModel", "Features", "ShowAttendTellModel",
           "ShowTellModel", "StackAttModel", "StackCapModel", "TopDownModel",
           "TransformerModel", "setup"]
