"""Configuration (the port's copy of the training and model fields of
`unpaired_image_captioning_tpu/config.py`).

Field names and defaults are the JAX package's (they match the reference
CLI flags); `finalize()` validates and derives the run id as there. The
port's entry points read a config by attribute, so a JAX `Config` works as
well as this one.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class Config:
    # --- flags: which sub-tasks run (opts.py group 1) ---
    i2t_train_flag: bool = False
    nmt_train_flag: bool = False
    nmt_kld_train_flag: bool = False

    # --- data: the prepro_ngrams df cache of the SCST rewards
    # (`scripts/prepro_ngrams.py::load_df_table`) ---
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

    # --- raw-image front end ---
    # decode captions for an arbitrary folder of images through the
    # on-the-fly ResNet (ref dataloaderraw.py:25-141, reached from
    # eval_pivot.py:204-210)
    image_folder: str = ""
    image_size: int = 448
    resnet_depth: str = "resnet101"       # raw-image front end (ref --model)

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

    # --- checkpointing / misc ---
    checkpoint_path: str = "save"
    save_checkpoint_every: int = 2500
    losses_log_every: int = 25
    language_eval: int = 0
    load_best_score: int = 1
    train_only: int = 0
    cider_reward_weight: float = 1.0
    bleu_reward_weight: float = 0.0
    seed: int = 123
    id: str = ""

    # --- derived (filled from the data) ---
    vocab_size: int = 0

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

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
