"""Configuration (the port's copy of `unpaired_image_captioning_tpu/config.py`).

Mirrors the reference's three config idioms (SURVEY.md §5.6):

1. a monolithic flag namespace with ``i2t_*`` / ``nmt_*`` prefixes and
   validity asserts (reference ``opts.py:6-181``), here a typed dataclass
   with an auto-generated argparse CLI (`build_parser`, `parse_opt`);
2. checkpoint-opts override: eval entry points copy every option from a
   saved run's config except an explicit ignore list and *assert equality*
   for load-bearing model-shape options (reference ``eval_paired.py:81-91``,
   `merge_checkpoint_config`);
3. ``transfer_args``: deriving the NMT sub-config by stripping the ``nmt_``
   prefix (reference ``misc/utils.py:35-40``).

Field names and defaults are the JAX package's, so recipes port 1:1, with
one addition: `device` (the port's own: where the CLIs build, "cuda"
unless the caller names another; `num_devices` counts ranks on its kind
of device, 0 being every visible card: `parallel.launch.num_ranks`).
`dtype` is the compute dtype, "bfloat16" by default as in JAX: with
"bfloat16" the trainer rounds the features to bf16 on the host, and on a
card it computes with bf16 copies of its f32 master parameters
(`train/trainer.py`); "float32" is the parity route. `param_dtype` is
kept and read by nothing, as in JAX. The port's entry points read a config by attribute, so a JAX
`Config` works as well as this one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field, fields
from typing import List, Optional


@dataclass
class Config:
    # --- flags: which sub-tasks run (opts.py group 1) ---
    i2t_train_flag: bool = False
    i2t_eval_flag: bool = False
    nmt_train_flag: bool = False
    nmt_eval_flag: bool = False
    coco_eval_flag: bool = False
    nmt_kld_train_flag: bool = False
    use_blob_fetcher: bool = False

    # --- data inputs ---
    input_json: str = "data/chinese_talk.json"
    input_coco_json: str = ""
    # raw-image eval: decode captions for an arbitrary folder of images via
    # the on-the-fly ResNet front-end (ref dataloaderraw.py:25-141, reached
    # from eval_pivot.py:204-210)
    image_folder: str = ""
    image_size: int = 448
    resnet_depth: str = "resnet101"  # raw-image front-end (ref --model)
    # flickr30k route of the unpaired eval (ref eval_unpaired.py:289-325):
    # score a caption text file vs flickr30k-style references
    # re-estimate use_bn running statistics from N data batches before eval
    # (for checkpoints without stats; ref AttModel.py:79-84 train-mode BN)
    bn_calibrate: int = 0
    eval_30k: str = ""          # path to the captions text file
    eval_30k_mode: str = "offline"   # offline | online (in-house NMT)
    flickr_refs: str = ""       # json: image_id -> [reference captions]
    flickr_ids: str = ""        # json list of image ids (line-aligned)
    input_fc_dir: str = "data/aic_fc"
    input_att_dir: str = "data/aic_att"
    input_box_dir: str = ""
    input_box_cls_prob_dir: str = ""
    input_fc_h5: str = ""
    input_att_h5: str = ""
    input_fc_coco_h5: str = ""
    input_att_coco_h5: str = ""
    input_label_h5: str = "data/chinese_talk_label.h5"
    input_label_coco_h5: str = ""
    input_nmt_choice: str = "h5"          # 'h5' | 'pt' (here: 'npz' container)
    input_nmt_h5: str = ""
    input_nmt_pt: str = ""
    input_nmt_dict: str = ""
    start_from: Optional[str] = None
    cached_tokens: str = "data/aic-train-idxs"

    # --- caption model ---
    caption_model: str = "fc"             # fc|att2in|att2in2|att2all2|adaatt|adaattmo|topdown|stackatt|denseatt|transformer|stackcap|show_tell|show_attend_tell
    rnn_size: int = 512
    num_layers: int = 1
    rnn_type: str = "lstm"
    input_encoding_size: int = 512
    att_hid_size: int = 512
    attri_hid_size: int = 512
    fc_feat_size: int = 2048
    att_feat_size: int = 2048
    attri_feat_size: int = 1601
    logit_layers: int = 1
    use_bn: int = 0                       # 0 | 1 (bn) | 2 (bn+ln) — reference AttModel.py:79-84
    num_heads: int = 8                    # transformer
    drop_prob_lm: float = 0.5

    # --- NMT model ---
    layers: int = 1
    word_vec_size: int = 512
    feature_vec_size: int = 100
    # `word￨feat` source-feature vocab sizes (one per column), filled from
    # the preprocess artifacts' *.src_feature_{j}.dict.json when training
    # a featured corpus (fork train.py:370-384 dicts['src_features'])
    nmt_src_feature_sizes: tuple = ()
    input_feed: int = 1
    residual: bool = False
    brnn: bool = True
    brnn_merge: str = "concat"
    copy_attn: bool = False
    coverage_attn: bool = False
    # opt-in coverage->attention feedback; the reference accumulates
    # coverage but never feeds it into GlobalAttention at any call site
    # (models/nmt.py NMTDecoder.coverage_feed)
    coverage_feed: bool = False
    exhaustion_loss: bool = False
    lambda_exhaust: float = 0.001
    lambda_coverage: float = 1.0
    lambda_fertility: float = 0.4
    context_gate: Optional[str] = None
    attention_type: str = "dotprod"       # dotprod | mlp
    attn_transform: str = "softmax"       # softmax|sparsemax|constrained_softmax|constrained_sparsemax
    c_attn: float = 0.0
    fertility: Optional[float] = None
    # fertility sources for the constrained transforms (opts.py:74-77):
    # predict = learned per-word head (fork Models.py:214-222,275-287);
    # guided = fast_align-style alignment file -> per-word max-fertility
    # table (utils/fertility.py, evaluation.py:147-191). supervised is
    # mirrored for schema parity but N/A at runtime: the upstream loss
    # shards keys never added to the shard dict (onmt/Loss.py:203-205
    # true/predicted_fertility_vals KeyError) — the path cannot execute.
    predict_fertility: bool = False
    guided_fertility: Optional[str] = None         # alignment file
    guided_fertility_source_file: Optional[str] = None
    supervised_fertility: Optional[str] = None     # N/A (see above)
    position_encoding: bool = False
    share_decoder_embeddings: bool = False
    dropout: float = 0.3
    nmt_model_type: str = "rnn"           # rnn | transformer (train.sh zh2en recipe)
    # opts.py/fork-train.py schema mirrors (round 5):
    encoder_layer: str = "rnn"   # rnn | transformer (fork twin); "mean" is
    # N/A-by-broken-upstream (Models.py:251-255 2-tuple vs 3-unpack :598)
    decoder_layer: str = "rnn"
    curriculum: int = 0          # length-sorted batch order for N epochs
    extra_shuffle: bool = False  # permute batch blocks each epoch
    truncated_decoder: int = 0   # truncated-BPTT segment (models/nmt.py)
    pre_word_vecs_enc: str = ""  # pretrained src embeddings (.npy/.npz)
    pre_word_vecs_dec: str = ""  # pretrained tgt embeddings
    input_nmt_align: str = ""    # mirrored; consumption commented out
    # upstream (dataloader.py:80)
    input_box_keep_boxes_dir: str = ""  # mirrored; stored but never read
    # upstream (dataloader.py:73 is its only appearance)
    label_smoothing: float = 0.0          # NMT label smoothing (transformer recipe)
    nmt_src_vocab_size: int = 0           # filled from data
    nmt_tgt_vocab_size: int = 0

    # --- features ---
    norm_att_feat: int = 0
    use_box: int = 0
    use_box_cls_prob: int = 0
    norm_box_feat: int = 0
    # feature-assembly worker processes for the train input pipeline
    # (reference: BlobFetcher hardcodes 4 torch workers, dataloader.py:376;
    # 0 = synchronous get_batch)
    input_workers: int = 0
    # frozen pretrained en (COCO) captioner embedding table (.npz with
    # 'embedding' [V+1, E]) for the target-side Weight_Trans_y coupling —
    # the reference hardcodes a coco model-best.pth path
    # (criterion.py:380-381); pair with input_coco_json for the coco vocab
    input_coco_wemb: str = ""

    # --- optimization: general ---
    max_epochs: int = 40
    batch_size: int = 16
    max_generator_batches: int = 32
    self_critical_after: int = -1
    seq_per_img: int = 5
    beam_size: int = 1
    seq_length: int = 20                  # max caption length (prepro --max_length)

    # --- optimization: i2t ---
    i2t_optim: str = "adam"
    i2t_momentum: float = 0.9
    i2t_learning_rate: float = 5e-4
    i2t_learning_rate_decay_start: int = -1
    i2t_learning_rate_decay_every: int = 3
    i2t_learning_rate_decay_rate: float = 0.8
    i2t_optim_alpha: float = 0.9
    i2t_optim_beta: float = 0.999
    i2t_optim_epsilon: float = 1e-8
    i2t_decay_method: str = ""
    i2t_weight_decay: float = 0.0
    i2t_max_grad_norm: float = 5.0
    i2t_grad_clip: float = 0.1
    scheduled_sampling_start: int = -1
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25

    # --- optimization: nmt ---
    nmt_optim: str = "sgd"
    nmt_momentum: float = 0.9
    nmt_learning_rate: float = 1.0
    nmt_learning_rate_decay_start: int = -1
    nmt_learning_rate_decay_every: int = 3
    nmt_learning_rate_decay_rate: float = 0.5
    nmt_optim_alpha: float = 0.9
    nmt_optim_beta: float = 0.999
    nmt_optim_epsilon: float = 1e-8
    nmt_decay_method: str = ""
    nmt_warmup_steps: int = 4000
    nmt_weight_decay: float = 0.0
    nmt_max_grad_norm: float = 5.0
    nmt_grad_clip: float = 5.0

    # --- eval / checkpointing ---
    val_images_use: int = 3200
    save_checkpoint_every: int = 2500
    checkpoint_path: str = "save"
    language_eval: int = 0
    # adds the SPICE column to the coco scoring route (stand-in scorer, not
    # jar parity — see eval/metrics/spice.py); ref pycocoevalcap/eval.py:9-40
    spice: int = 0
    losses_log_every: int = 25
    load_best_score: int = 1

    # --- SCST ---
    cider_reward_weight: float = 1.0
    bleu_reward_weight: float = 0.0

    # --- misc ---
    seed: int = 123
    id: str = ""
    train_only: int = 0
    gpus: List[int] = field(default_factory=list)  # kept for CLI parity; ignored
    num_devices: int = 0                  # 0 = all visible devices
    mesh_shape: str = "data"              # parallel axis spec, see parallel/mesh.py
    dtype: str = "bfloat16"               # compute dtype: bfloat16 | float32
    param_dtype: str = "float32"          # the masters' dtype (read by nothing)
    # where the CLIs build the models and run the steps (the port's own)
    device: str = "cuda"

    # --- derived (filled by finalize) ---
    vocab_size: int = 0
    coco_vocab_size: int = 0

    def validate(self) -> None:
        """Validity asserts (parity: opts.py:158-170)."""
        assert self.rnn_size > 0, "rnn_size should be greater than 0"
        assert self.num_layers > 0, "num_layers should be greater than 0"
        assert self.input_encoding_size > 0, "input_encoding_size should be greater than 0"
        assert self.batch_size > 0, "batch_size should be greater than 0"
        assert 0 <= self.drop_prob_lm < 1, "drop_prob_lm should be between 0 and 1"
        assert self.seq_per_img > 0, "seq_per_img should be greater than 0"
        assert self.beam_size > 0, "beam_size should be greater than 0"
        assert self.save_checkpoint_every > 0, "save_checkpoint_every should be greater than 0"
        assert self.losses_log_every > 0, "losses_log_every should be greater than 0"
        assert self.language_eval in (0, 1), "language_eval should be 0 or 1"
        assert self.load_best_score in (0, 1), "load_best_score should be 0 or 1"
        assert self.train_only in (0, 1), "train_only should be 0 or 1"

    def finalize(self) -> "Config":
        """Derive run id and checkpoint path (parity: opts.py:172-179)."""
        self.validate()
        if not self.id:
            self.id = time.strftime("%Y%m%d-%H%M%S") + "." + self.caption_model
        if self.checkpoint_path == "save":
            self.checkpoint_path = "save/" + self.id
        return self

    # --- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# Options an eval script may override without touching the saved run config
# (parity: eval_paired.py ignore list semantics).
EVAL_OVERRIDE_KEYS = frozenset({
    "id", "batch_size", "beam_size", "start_from", "language_eval",
    "val_images_use", "input_fc_dir", "input_att_dir", "input_box_dir",
    "input_box_cls_prob_dir", "input_json", "input_coco_json",
    "input_label_h5", "input_label_coco_h5", "input_fc_h5", "input_att_h5",
    "input_nmt_h5", "input_nmt_pt", "input_nmt_dict", "checkpoint_path",
    "num_devices", "mesh_shape", "gpus", "seed", "device",
    "image_folder", "image_size", "spice", "resnet_depth",
    "eval_30k", "eval_30k_mode", "flickr_refs", "flickr_ids", "bn_calibrate",
})

# Model-shape options that MUST match the checkpoint (parity: train.py:30-35).
CHECKPOINT_COMPAT_KEYS = ("caption_model", "rnn_type", "rnn_size", "num_layers",
                          "input_encoding_size", "vocab_size")


def merge_checkpoint_config(cli: Config, saved: Config) -> Config:
    """Apply checkpoint-opts override semantics (eval_paired.py:81-91).

    Every saved option is copied onto the CLI config except
    EVAL_OVERRIDE_KEYS; for CHECKPOINT_COMPAT_KEYS a mismatching explicit CLI
    value raises.
    """
    out = dataclasses.replace(cli)
    for f in fields(Config):
        k = f.name
        if k in EVAL_OVERRIDE_KEYS:
            continue
        saved_v = getattr(saved, k)
        cli_v = getattr(cli, k)
        default_v = f.default if f.default is not dataclasses.MISSING else None
        if k in CHECKPOINT_COMPAT_KEYS and cli_v != saved_v and cli_v != default_v and default_v is not None:
            raise ValueError(
                f"config mismatch vs checkpoint for {k!r}: cli={cli_v!r} saved={saved_v!r}")
        setattr(out, k, saved_v)
    return out


def transfer_args(cfg: Config) -> argparse.Namespace:
    """Build the NMT sub-config by stripping `nmt_` prefixes
    (parity: misc/utils.py:35-40) and including the shared NMT fields."""
    ns = argparse.Namespace()
    for f in fields(Config):
        k = f.name
        if k.startswith("nmt_"):
            setattr(ns, k[len("nmt_"):], getattr(cfg, k))
        else:
            setattr(ns, k, getattr(cfg, k))
    return ns


def build_parser(defaults: Optional[Config] = None) -> argparse.ArgumentParser:
    """argparse CLI auto-generated from the Config dataclass; flag names match
    the reference opts.py surface."""
    defaults = defaults or Config()
    p = argparse.ArgumentParser(description="unpaired_image_captioning_tpu_torch")
    for f in fields(Config):
        name = "--" + f.name
        default = getattr(defaults, f.name)
        if f.type in ("bool", bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=default)
        elif f.type in ("List[int]", List[int]) or f.name == "gpus":
            p.add_argument(name, type=int, nargs="*", default=default)
        elif f.type in ("Optional[str]", Optional[str]):
            p.add_argument(name, type=str, default=default)
        elif f.type in ("Optional[float]", Optional[float]):
            p.add_argument(name, type=float, default=default)
        elif f.type in ("int", int):
            p.add_argument(name, type=int, default=default)
        elif f.type in ("float", float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def parse_opt(argv: Optional[List[str]] = None) -> Config:
    """CLI entry (parity: opts.py parse_opt)."""
    ns = build_parser().parse_args(argv)
    return Config.from_dict(vars(ns)).finalize()
