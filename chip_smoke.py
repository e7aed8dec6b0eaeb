#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --times att,tfd
    python3 chip_smoke.py --times ln,img

Builds the port's CUDA kernels from `unpaired_image_captioning_tpu_torch/
csrc/`, holds each kernel against its plain PyTorch version at the serving
paths' shapes, then serves the pivot task at full width with random weights
made from seed 0, on two paths: the LSTM pivot (denseatt beam 5 -> BiLSTM
NMT beam 15) and the transformer pivot (6-layer transformer captioner beam
5 -> 6-layer transformer NMT beam 15). Each path answers 40 concurrent
requests to `PivotService` and one `POST /pivot` through the HTTP front
end; the script checks that each path launched its kernels (the launch
counts are set to 0 just before a path runs and read just after it),
times a batch-50 `pivot_translate`, runs the captioner's per-layer decode
route and compares four images against the same models on the CPU.

The LSTM cell is held against its plain version at each of the path's
shapes (one launch a call); its line before each reading names the tile
and the cluster size the kernel picked for the shape, and where it splits
the reduction across a cluster, the same tile without one is timed too.

Then it trains: the training attention, training LayerNorm and
whole-layer kernels (encoder and decoder layer) are held against their
plain versions (forward and backward, dropout on, each backward twice bit
for bit; the attention's forward twice too, with its rows' softmax
statistics) at the transformer captioner's training shapes (the encoder
layer also at the transformer NMT's: 16 positions, d_ff 2048), each
whole layer beside cuBLAS (TF32 off) over its products alone, and
`Trainer.train` trains the full-width transformer captioner (bench.py's
transformer XE configuration: 6 + 6 layers, d 512, batch 50, Adam) on
random data from seed 0 on each of its three routes: 2 + 5 steps on the
default route (every encoder layer one whole-layer kernel call: 6 + 6 layer
launches, 12 + 12 attention and 20 + 20 LayerNorm launches a step), 2 + 5
per sublayer (18 + 18 and 32 + 32) and 2 + 5 with whole decoder layers too
(6 + 6 of each layer kernel, 2 + 2 LayerNorms). One step on two images,
all dropout off, is compared with the same step on the CPU on the default
route and on the whole-decoder-layer route.

The denseatt captioner (the LSTM pivot's) is driven on the card too: the
three additive-attention kernels (single query, K beams, the fused att1 ->
lstm1 -> att2 decode step) against their plain versions at B 50, N 196,
A = D = H = 512 (each image's slots split across a cluster; the step's
CUDA launches counted), and the LSTM cell's backward against plain
autograd; greedy
`sample` at batch 50 on the default route, with SINGLE_KERNEL and with
STEP_FUSION, and beam 5 with BEAMS_KERNEL through a batch-50
`pivot_translate` (launches checked against the steps each decode ran);
four images per route against the CPU; `CaptionService(greedy=True)`
through the micro-batcher and HTTP. `Trainer.train` trains it at full
width (bench.py's denseatt XE configuration: batch 50, Adam, clip 5) on
its default route and with TRAIN_KERNEL, 2 + 5 steps each (51 lstm_cell
launches a step; 34 additive_attention launches more with TRAIN_KERNEL),
and one step on two images is compared with the CPU on both routes,
including that every parameter that moves on the CPU moves on the card.

Beams wider than 16: the chunked top-k kernel (16 < k <= 64) is held
against its plain version at [1600, 8571] k=32, [1000, 9488] k=20,
[1600, 9488] k=32 and [256, 16384] k=64, on rows built to break a naive
version; the LSTM pivot runs at caption beam 20 -> NMT beam 32, batch 50
(one chunked launch a decode step, four images token-identical to the
CPU), the NMT at beam 40 through the counted sort (`ops/topk.py
::sort_calls`), and the transformer NMT at beam 32. The NMT trains at
bench width: the BiLSTM NMT alone (49 lstm_cell launches a step), jointly
with denseatt under Weight_Trans, Weight_Trans_y and a KLD teacher (149),
and the transformer NMT on its default route, 2 + 5 steps each; the memory and wall of a denseatt step are read with the plain
attention recomputed in its backward and called directly; the K-beam
attention kernel (BEAMS_KERNEL) decodes four images at caption beam 20
against the CPU; one step of the BiLSTM NMT and one of the joint step are
compared with the CPU, every parameter that moves on
the CPU moving on the card too.

SCST (self-critical training) at bench.py's point: the df table of a
seeded corpus of 2,000 images x 5 captions from the port's
`prepro_ngrams.compute_df`, on the card; CIDEr-D, BLEU-4 and the advantage
on given sequences [50, 16] against gts [50, 5, 16], card vs CPU, and the
reward's device time and operations; `Trainer._rl_loss` and its gradient
on given sequences for two images of denseatt and of the transformer
captioner, card vs CPU; `Trainer.train(sc_flag=True)` at batch 50, 2 + 5
steps of each family (144 lstm_cell launches a denseatt step: sample,
greedy baseline and recompute; 32 decoder-stack launches a transformer
step) and 2 + 2 joint steps with the BiLSTM NMT, each with a reward above
0 and its captioner's parameters moved; one denseatt step with
STEP_FUSION, whose decodes launch the fused step and whose recompute
(under grad) does not.

The raw-image path: the image front end (B11) is held against its plain
version at [16, 480, 640, 3] -> 448 x 448 and at the loader's identity
size (there bit-equal to the host's `preprocess_images`); 16 seeded uint8
.npy images of 375 x 500 and 480 x 640 go through `RawImageLoader` (host
read and nearest resize, uint8 upload, B11, ResNet-101 at 448 with
converted weights from a generated torchvision state dict) into the LSTM
pivot; `prepro_feats.main` writes four images' feature files; ResNet-101
runs on two images on the card and on the CPU with the same weights. The
blocked LSTM chain (B10) is held against its plain version, forward and
backward (each twice bit for bit), at the lstm0 fragment's shape (B 50,
T 17, D 1024, H 512) for G = 5 and G = 4, and against 17 `lstm_cell` steps
with autograd; the
fragment then runs once through `blocked_lstm_chain` with its launch
counts read.

Head widths other than 32, 64 and 128: the training attention (forward
and backward), the whole encoder and decoder layers and the decoder step
are held against their plain versions at head widths 96 (d 768 over 8
heads), 256 (d 512 over 2), 50 (d 100 over 2: 4-byte copies), 384 and
512 (one head: column chunks) and, for the layers and the step, a d_ff of
510; the attention also over 1,500 keys and the step at 32 beams of width
256 and at dh 6; a 2-layer transformer captioner at head widths 96, 256,
6, 50, 384 and 512, at a d_ff of 510 and at d 30 (5 heads of 6, d_ff
45) takes one XE step on each
training route (kernel launches counted) and decodes four images at beam
5, card vs CPU (top beams identical). The beam top-k (B2 and B3, one
radix select in `csrc/topk_select.cu`) is also held exact on rows with
NaN, which ranks above +inf.

The training CLI (`python -m unpaired_image_captioning_tpu_torch.cli.train`,
driven through `cli.train.main`) at full width on artifacts that the
port's `data/synthetic.py` writes to a temporary directory: 100 train, 50
val and 10 test images of CAP's vocabulary with 5 captions each (fc 2,048,
att 196 x 2,048 as `.npy` files), 2,000 + 100 NMT pairs at NMT's
vocabularies (`.npz`), dicts that align all 9,487 caption words for
Weight_Trans, and the df cache of the port's `prepro_ngrams`. Denseatt
jointly with the BiLSTM NMT at batch 50 x 5 captions: 7 XE steps, then 2
SCST steps from epoch 3 (`avg_reward` exactly there), eval with the
caption metrics at beam 3 and a checkpoint (with the `-best` track) every
4 steps; the same stopped at epoch 3 and resumed with `--start_from`,
whose final parameters and optimizer state must equal the full run's bit
for bit; the transformer captioner at TCAP's widths, 3 XE steps and an
eval at beam 3. It reads the step walls, the eval walls, the
checkpoint's size and its write and load times, and the launches of B1
and B2 (and of B4, B5, B6 and B8 in the transformer run), which the
kernels line adds. The shapes the recipe gives its kernels are among
those held against the plain versions above: B1 at 150 maxout rows (the
eval's beam 3 over 50 images) and at the NMT decoder's 50 teacher-forced
rows, B4 at beam 3 x 50, and B5, B6 and B8 at the XE step's 250 rows
(the loader's 50 images x 5 captions, features repeated).

Then the eval and migration surface on those run dirs (`phase_eval_clis`):
`cli.eval_unpaired` on the joint run's last checkpoint at caption beam 5
-> NMT beam 15 against English references made of the target dict's
words, `cli.eval_pivot` (the staged route through `cli.translate`) with
the same zh and en predictions (both read the 10 test images as one
batch), both again on a twin of the run at the trainer's initial weights
(where, unlike after the recipe's 9 steps on random captions, every
caption has words),
`cli.eval_paired` on the denseatt and the transformer run dirs,
`cli.eval_pivot --image_folder` on four raw images (B11, ResNet-101 with
random weights), `scripts.migrate_reference` on a reference-layout
denseatt + BiLSTM NMT pair generated at the recipe's widths, then
`cli.eval_unpaired` on the migrated dir and the migrated weights card vs
CPU (`phase_agreement`'s check), and the recipe once more with
`--input_workers 2`, whose parameters and Adam moments must equal the
full run's bit for bit. Each CLI's wall and its launches of B1, B2, B4
and B11 are logged (counts set to 0 just before it, read just after),
and the kernels line adds them.

Then raw files to a trained, profiled model on the port alone
(`phase_raw_data`): seeded AIC-style annotations of the recipe's 160
images (5 captions each, 一个 ... at their head), a zh-en text corpus of
2,000 + 100 lines and a bottom-up TSV (36 boxes x 2,048 f32 an image) go
through the port's `prepro_split_tokenize`, `prepro_labels` (.npz; CAP's
9,487-word vocabulary with UNK, asserted), `prepro_ngrams`,
`prepro_reference_json`, `cli.preprocess` (dicts pruned to NMT's 11,986 /
8,571, asserted; once more learning 30 BPE merges), the dicts joined as a
user joins them, and `make_bu_data`; then `cli.train` on the card (the
joint denseatt + BiLSTM NMT at batch 50 x 5 captions, 5 XE steps, an
eval at beam 3), `Trainer.profile` over 3 steps (its Chrome trace must
name every kernel whose count those steps moved; the five device
operations that took the most time are logged),
`prepro_backtranslate --provider nmt` on the run dir at beam 5 (B1 and
B2 must launch) and the reports (`html_report`,
`word_cloud_from_captions`, `vis_words`) on the eval's predictions. The
shapes the phase gives B1 and B2 must be ones the checks hold; its
launches join the kernels line.

Then the other caption families (`phase_families`, ROADMAP A10): B1 at
each cell shape they give it (fc's G=5 512 -> 512, TopDown's G=4 1,536 and
1,024 -> 512, ShowTell's G=4 512 -> 512, AllImg's and ShowAttendTell's G=4
2,560 -> 512, StackCap's G=5 1,024 and 1,536 -> 512, at 4 to 250 rows)
against the plain cell, forward and backward, and B2 at the beam-3 rows
of 4 and 10 images; each of fc, TopDown, Att2in, Att2in2, Att2all2,
AdaAtt, AdaAttMO, ShowTell, AllImg, ShowAttendTell and StackCap at CAP's
widths (StackCap's 1,601 attributes): teacher-forced logprobs of 4 images
card vs CPU within 1e-3, 2 XE steps (the dropout-free loss falling) and 1
SCST step of `Trainer.train` at batch 10 x 5, a beam-3 decode of 50
images; train.sh's XE -> SCST recipe for fc and stackcap through
`cli.train` (4 + 1 XE steps with evals and checkpoints, then 4 SCST steps
with `--start_from`; fc's SCST stage once more stopped and resumed, bit
for bit), `cli.eval_ensemble` over those two run dirs, a use_bn 2 TopDown
run dir through `cli.eval_paired --bn_calibrate 2`, one transformer use_bn
1 XE step, and TopDown's beam-3 decode with the four B9 flags on against
off. Its B1 and B2 launches join the kernels line, and every shape it
gives them must be one the checks hold.

Then diverse beam groups and the NMT extras (`phase_nmt_extras`, ROADMAP
A10 and A11): B1 at the NMT's cells without input feed (G=4 512 -> 512 at
2 to 750 rows), NMTImageEncoder's (2,048 -> 256 at 16 rows) and the
denseatt's at beam 6, and B2 at the grouped rows ([50, 18,976] k=2) and the
extended copy vocab ([750, 8,587] k=15), against their plain versions (B4
at the transformer's diverse beams among the decoder step's shapes); diverse
groups on denseatt (beam 6 in 3 groups) and the transformer captioner
(beam 4 in 2), batch 50 timed and 4 images card vs CPU; the LSTM pivot's
NMT in four variants (copy + context gate + coverage + positional encoding
+ shared embeddings; constrained softmax with predicted fertility and two
source features; constrained sparsemax with guided fertility, mlp
attention, no input feed and coverage feedback; sparsemax), each with
teacher-forced logprobs and a beam-15 translation of 4 sentences card vs
CPU, a batch-50 translation, one `Trainer.train` step card vs CPU and one
at batch 50; NMTImageEncoder on a [16, 14, 14, 2,048] grid card vs CPU;
the copy model behind `pivot_translate` (images/s beside the plain NMT's),
`eval_split_coco_unpaired(src2tgt=...)` and `cli.translate -copy_mode
extended` / `fold`. Its B1, B2 and B4 launches join the kernels line, and
every shape it gives them must be one the checks hold.

Then the fork's post-norm transformer (`phase_fork_transformer`, ROADMAP
A12) at d 512, d_inner 2,048, 6 + 6 layers, 8 heads on NMT's
vocabularies, loaded through `convert_fork_transformer` from a seeded
fork state dict: teacher-forced logprobs and attention of 50 sentences
of 20 words card vs CPU, `translate_greedy` to 50 token-identical on 4
sentences (generator sharpened), and its greedy sentences/s on 50; no
kernel serves it (plain torch, as XLA in JAX). Then scale-out
(`phase_scale_out`, A14): the joint denseatt + BiLSTM NMT step with
Weight_Trans at the recipe's global batch (50 images x 5 captions, 50
pairs; SGD with momentum, dropout off), twice, then a joint SCST step on
given samples and a beam-3 decode, on one device as the reference and
then on the routes chosen from the card count: 2 gloo ranks sharing the
card ("2", and "1x2" with the captioner's tensor-parallel placements),
one NCCL rank, and 2 NCCL ranks across cards where two are visible. Each
route's losses and parameters equal the reference's within 1e-5, each
rank launches B1, B2 and B9, each "1x2" rank holds half of every
model-sharded leaf, and the "2" route's checkpoint loads into a
one-device Trainer bit for bit; every shape the ranks give B1, B2 and B9
is held against its plain version, and rank 0's launches on "2" join the
kernels line.

The compute dtype (ROADMAP A15): after the f32 kernel checks, the bf16
entries of B1, B9a-c and B10 (`phase_bf16_kernels`) are held against their
plain versions at rtol = atol = 1e-2 in every dtype mixture the routes
give them (B1 at G=5 [50] and [150] x 1024->512, G=4 [50] x 512->256 and
1024->512; B9a and B9b at K = 3, 5 over [50, 196, 512]; B9c at B 50, H
512; B10 at the lstm0 fragment's shape), each timed beside its f32 entry,
its bound counting a bf16 element as 2 bytes and the products of two bf16
operands at the bf16 tensor-core rate; `torch.lstm_cell` on bf16 tensors
(and cuDNN's bf16 LSTM for B10 at G = 4) where one computes the function.
Last, the bf16 path (`phase_bf16_path`): the joint denseatt + BiLSTM NMT
XE step with `dtype="bfloat16"` (bf16 copies of the f32 masters) at batch
50, its loss falling over 4 steps, one more with TRAIN_KERNEL; one SCST
step; the LSTM pivot through `PivotService`, which rounds the features
to bf16 on the card; bf16-feature decodes with SINGLE_KERNEL, STEP_FUSION
and BEAMS_KERNEL; the lstm0 fragment with a bf16 carry; the joint step's
loss and gradients on two images and the pivot's teacher-forced logprobs
on four, card vs CPU on the same rounded features and bf16 copies, at
1e-2. The second part of A15 (`phase_bf16_tf_kernels`): the bf16 entries
of the transformer kernels held against their plain versions in every
mixture the routes give them, at the path shapes (B8 at the captioner's
and the NMT's rows, x with bf16 or f32 parameters; B5 at the encoder's,
the decoder's and the NMT's attentions; B6 at the captioner's and the
NMT's encoder layer, B7 at the captioner's decoder layer, forward and
backward; B4's stack and layer at beam 5 x 50 and batch 50 with f32
weights over bf16 caches and memory and with every operand bf16; B11's
bf16 store, bit for bit the host's rounding at the identity size), each
timed beside its f32 entry with the library call where one computes it
(SDPA on bf16 tensors; the steps' GEMMs alone in bf16 cuBLAS;
F.interpolate); and in the bf16 path the transformer captioner's bf16 XE
(4 steps on the default route with the loss falling, one per sublayer and
one with whole decoder layers), one transformer SCST step, 2 transformer
NMT steps, the transformer pivot through `PivotService` (40 requests), a
greedy decode one layer a call, B11's bf16 store, and the captioner's
bf16 step card vs CPU on 2 images at 1e-2. Every (shape, dtype mixture) a
bf16 phase gives a kernel is held against the plain version (the
transformer kernels on the very inputs of the first call of each); so is
every bf16 mixture the eval CLIs, the recipe and the families phases give
B1 (the card's eval rounds the features), and `eval_unpaired`, whose
route does not round, reads the features of its comparison with
`eval_pivot` through a bf16 loader. Every f32 phase names
`dtype="float32"` (the default is "bfloat16"). The kernels line gains the
bf16 entries (`*_bf16`) with the bf16 path's launches. B5's all-bf16 calls
run its tensor-core instance (`csrc/mha_train_tc.cuh`): each path shape
and four ragged ones (head widths 32, 96, 128 and 256; T and S off the
64-row tiles; one key) are held with the backward rerun bit for bit and
the instance's CUDA kernels seen by the profiler, and the bf16 path
asserts that every bf16 B5 call, alone and inside B6 / B7, went through
the tensor cores (`tc_launches`, `tc_launches_in_layers` on the B5
records). B4's typed steps (`kernels/transformer_decode.py::route`): both
bf16 mixtures of the path take the fast attentions over bf16 caches and
memory, and the all-bf16 step's products the tensor cores; each path
pair is held with its route and tensor-core count, and the bf16 path
asserts every bf16 B4 call on the fast attentions and every all-bf16 one
on the tensor cores (`tc_launches` on the B4 bf16 records). ROADMAP C5
(`_c5_check`): the all-bf16 stack at the caption beam's shape at 8 draws
of its own, each layer alone held at 1e-2 of each output's scale against
its plain version fed the plain output of the layer before, the whole
stack read and recorded (`c5` on the stack's bf16 record).

Every kernel's line in the `kernels` JSON carries its device time, its
plain version's, its bound (the largest of bytes over 3.35 TB/s, f32
operations over 67 TFLOP/s and, for the additive attentions, their tanh,
exp and gate evaluations over the special-function units' 16 a clock an
SM at the card's maximum SM clock, from this run's shapes; `bound_term`
names the term that sets it) and, where one PyTorch call computes the same
function, that call's time. The last line is
`{"ok": true, "device": {...}}`.

Numerics: f32, with TF32 off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), but where a phase says bf16:
the bf16 phases above, and the features the card's serving and
`eval_split` round to bf16, as JAX's do on a TPU.

Widths past what a block once held whole: the training LayerNorm at d
4,096 and 6,000 (LN_WIDE), the whole encoder layer at d 4,096 on two
images, the decoder step at one head of 7,300 (the parent's refusal began
at 7,249 for B 2, 2 beams, 8 slots) and of 6,000 over 500 slots, B9a-c at
A + D = 64,000 over 8 slots, and B11 at rows that are not whole float4, at
one and four channels, the identity at such a width (bit-equal to the
host) and rows too long to stage; each against its plain version.

`--times GROUPS` only builds the kernels and times those of the named
groups (`topk`: both top-k entries at the shapes above, on the same rows;
`mha`: the training attention's forward and backward at the step's three
shapes, at head widths 32, 64 and 128; `att`: B9a, B9b at K = 3, 5 and 20
and B9c on the inputs of their checks; `tfd`: the decoder step's stack at
both pivot shapes, at head widths 32, 64 and 128, the first head width
the step refuses at TFD_REFUSAL_SHAPE, and its bf16 path pairs (stack and
layer at beam 5 x 50 and batch 50, f32, f32 weights over bf16 caches and
memory, all bf16) with their bound, bf16 cuBLAS over the products and the
tensor-core launches where the tree counts them; `steps`: the transformer
XE step in f32 and bf16, the bf16 transformer SCST step and a batch-50
transformer pivot over rounded features, host walls and one profiled
call's device busy; `ln`: the training LayerNorm's
forward and backward at LN_SHAPES and the whole encoder layer's backward
at the captioner's shape, split by kind of CUDA kernel; `img`: B11 at
IMG_CASES), with no check, and prints the readings as its last line. It serves to compare two checkouts on one
card: copy this script into each and run them in turns (A, B, B, A) in
one call.

Any failure raises, and the script exits non-zero. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np

# full-width serving configuration (captioner: the denseatt eval shapes;
# NMT: the zh->en BiLSTM at beam 15)
CAP = dict(vocab_size=9487, input_encoding_size=512, rnn_size=512,
           num_layers=1, drop_prob_lm=0.5, seq_length=16, fc_feat_size=2048,
           att_feat_size=2048, att_hid_size=512)
NMT = dict(src_vocab_size=11986, tgt_vocab_size=8571, word_vec_size=512,
           rnn_size=512, layers=1, brnn=True, dropout=0.3, beam_size=15,
           max_decode_len=20)
# the transformer pivot at full width (bench.py's transformer captioner and
# transformer NMT): d 512, 8 heads, 6 layers each
TCAP = dict(vocab_size=9487, input_encoding_size=512, rnn_size=512,
            num_layers=6, drop_prob_lm=0.5, seq_length=16, fc_feat_size=2048,
            att_feat_size=2048, att_hid_size=512, num_heads=8)
TNMT = dict(src_vocab_size=11986, tgt_vocab_size=8571, d_model=512,
            d_ff=2048, num_layers=6, num_heads=8, max_decode_len=20,
            beam_size=15)
N_SLOTS = 196               # 14 x 14 attention grid per image
CAP_BEAM, NMT_BEAM, NMT_MAX_LEN = 5, 15, 20
N_REQUESTS, MAX_BATCH, BENCH_BATCH = 40, 32, 50

LSTM_TOL = 1e-4   # f32 sums in another order than cuBLAS; TF32 off
# decoder step: max|diff| <= TFD_TOL * max(1, max|plain|) over x', caches and
# attention; f32 sums over d_ff = 2048 products in another order
TFD_TOL = 1e-4
AGREE_TOL = 1e-3  # card vs CPU over whole f32 models: sums in other orders
NMT_BOS = 2       # the NMT's BOS id (OpenNMT's Constants)
TOP_OPS = 12      # device operations listed for each path's batch-50 call
LEAD_IN = 32      # spin kernels opening each profiler session (see
LEAD_IN_SEEN = []  # `_profile_device_us`): (recorded, first event) a session

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): f32 outside
# the tensor cores, and device memory
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# transcendental evaluations (tanh, exp, sigmoid) a clock on each SM: the
# special-function units; times the SM count and the maximum SM clock
# (`nvidia-smi --query-gpu=clocks.max.sm`, read by `phase_device`)
SFU_PER_SM_CLOCK = 16
SFU_RATE = []     # [evaluations per second] once phase_device has read it

# transformer captioner XE training at full width (bench.py:268-274)
# (every f32 phase names dtype "float32": the default is "bfloat16")
TRAIN = dict(TCAP, caption_model="transformer", batch_size=50, seq_per_img=1,
             i2t_train_flag=True, nmt_train_flag=False, i2t_optim="adam",
             i2t_max_grad_norm=5.0, seed=0, dtype="float32")
TRAIN_WARMUP, TRAIN_STEPS, ROUTE_STEPS = 2, 5, 5


def _per_step(enc=0, dec=0, mha=0, ln=0) -> dict:
    """Launches of each kernel per training step, forward and backward."""
    n = {"enc_layer_train": enc, "dec_layer_train": dec, "mha_train": mha,
         "ln_train": ln}
    return {f"{k}_{x}": v for k, v in n.items() for x in ("fwd", "bwd")}


_L = TCAP["num_layers"]
# the training routes (label, TRAIN_LAYER_KERNEL, TRAIN_DEC_LAYER_KERNEL,
# timed steps, launches a step): the default runs each encoder layer as one
# whole-layer call and the decoder's 6 self and 6 cross attentions and its
# 18 + 2 LayerNorms per sublayer; per sublayer every layer runs 2 or 3
# attentions and 2 or 3 LayerNorms; with whole decoder layers only the two
# final LayerNorms stay outside the layer kernels
TRAIN_ROUTES = [
    ("default (whole encoder layers)", (True, False), TRAIN_STEPS,
     _per_step(enc=_L, mha=2 * _L, ln=3 * _L + 2)),
    ("per sublayer", (False, False), ROUTE_STEPS,
     _per_step(mha=3 * _L, ln=5 * _L + 2)),
    ("whole encoder and decoder layers", (True, True), ROUTE_STEPS,
     _per_step(enc=_L, dec=_L, ln=2)),
]
TRAIN_RATE = 0.1  # the attention dropout of the kernel checks
TRAIN_TOL = 1e-4  # max|diff| <= TRAIN_TOL * max(1, max|plain|)
# (label, B, T, S, mask kind[, d, heads]): the training attentions of one
# step (d 512 over 8 heads), then the encoder's at head widths 96 and 256,
# which run padded in bucket 128 and in bucket 256's 32-row tiles, and a
# cross-attention over 1,500 keys; then head widths 50 (4-byte copies) and
# 512 (column chunks)
MHA_SHAPES = [
    ("encoder self, T = S = 196, padded [B,1,S]", 50, 196, 196, "pad"),
    ("decoder cross, T = 17, S = 196", 50, 17, 196, "pad"),
    ("decoder self, T = S = 17, causal + pad [B,T,T]", 50, 17, 17, "causal"),
    ("encoder self, dh 96", 50, 196, 196, "pad", 768, 8),
    ("encoder self, dh 256", 50, 196, 196, "pad", 512, 2),
    ("cross over 1,500 keys", 8, 17, 1500, "pad"),
    ("encoder self, dh 50", 50, 196, 196, "pad", 100, 2),
    ("encoder self, dh 512", 50, 196, 196, "pad", 512, 1),
    # the recipe's transformer XE: the loader's 50 images x 5 captions
    ("decoder cross, recipe batch 50 x 5", 250, 17, 196, "pad"),
    ("decoder self, recipe batch 50 x 5", 250, 17, 17, "causal"),
]
# the step's encoder and decoder rows, then the recipe's (50 x 5 captions)
LN_SHAPES = [("encoder", 50, 196, 512), ("decoder", 50, 17, 512),
             ("encoder, recipe batch 50 x 5", 250, 196, 512),
             ("decoder, recipe batch 50 x 5", 250, 17, 512)]
# the training LayerNorm past the width its backward once refused (3,632):
# a d-4,096 model's rows and a width off the register kernels' float4
LN_WIDE = [("d 4,096", 50, 17, 4096), ("d 6,000", 50, 17, 6000)]
# every CUDA kernel of csrc/ a training step launches, by name (the
# whole-layer wrappers launch all of them)
MHA_BWD_KERNELS = ("mha_dsum_kernel", "mha_bwd_dkdv_kernel",
                   "mha_bwd_dq_kernel")
# B5's tensor-core instance (the all-bf16 calls, csrc/mha_train_tc.cuh)
MHA_TC_FWD_KERNELS = ("mha_fwd_tc_kernel",)
MHA_TC_BWD_KERNELS = ("mha_bwd_rows_tc_kernel", "mha_bwd_dkdv_tc_kernel",
                      "mha_bwd_dq_tc_kernel")
LN_BWD_KERNELS = ("ln_bwd_rows_kernel", "ln_bwd_any_kernel")
TRAIN_KERNELS = ("train_gemm_kernel", "mha_fwd_kernel") + MHA_BWD_KERNELS + (
                 "ln_fwd_kernel",) + LN_BWD_KERNELS + (
                 "drop_kernel", "weight_transpose_kernel")

# denseatt captioner XE training at full width (bench.py:140-158): the
# serving captioner's widths, batch 50, labels [50, 18], drop_prob_lm 0.5,
# Adam, the global-norm clip 5
DTRAIN = dict(CAP, caption_model="denseatt", batch_size=50, seq_per_img=1,
              i2t_train_flag=True, nmt_train_flag=False, i2t_optim="adam",
              i2t_max_grad_norm=5.0, seed=0, dtype="float32")
_T1 = CAP["seq_length"] + 1      # teacher-forced inputs a sequence
# (label, (TRAIN_KERNEL,), timed steps, launches a step): 3 maxout cells a
# step of the sequence on both; the kernel route adds att1 and att2
DENSE_ROUTES = [
    ("default (plain attention)", (False,), TRAIN_STEPS,
     {"lstm_cell": 3 * _T1, "additive_attention": 0}),
    ("TRAIN_KERNEL", (True,), TRAIN_STEPS,
     {"lstm_cell": 3 * _T1, "additive_attention": 2 * _T1}),
]
# the LSTM cell's kernel (both tile widths are instances of one template)
LSTM_KERNELS = ("lstm_cell_kernel", "lstm_cell_tc_kernel")
DENSE_KERNELS = LSTM_KERNELS + ("additive_attention_kernel",)
ATT_TOL = 1e-4     # max|diff| <= ATT_TOL * max(1, max|plain|), each output
ATT_BEAMS = (3, 5, 20)  # the K-beam kernel's checks (20: two beam groups)
# the CUDA kernels of att_lstm_att_mixed (five launches a step: the two
# attentions, the cell and the two products)
STEP_KERNELS = ("additive_attention_kernel",
                "decode_gemm_kernel") + LSTM_KERNELS

# (label, B, D, H, maxout): the cells of the path at their beam batches
LSTM_SHAPES = [
    ("denseatt lstm0/1/2, beam 5 x 50", 250, 1024, 512, True),
    ("nmt encoder, per direction", 50, 512, 256, False),
    ("nmt decoder, beam 15 x 50", 750, 1024, 512, False),
    ("denseatt lstm0/1/2 and B9c, batch 50", 50, 1024, 512, True),
    ("ragged", 3, 100, 60, False),
    ("ragged maxout", 3, 100, 60, True),
    ("ragged, 4-byte copies", 5, 37, 50, True),
    # the recipe's: the denseatt eval at beam 3 over 50 images, and the
    # BiLSTM NMT's teacher-forced decoder at batch 50
    ("denseatt lstm0/1/2, recipe eval beam 3 x 50", 150, 1024, 512, True),
    ("nmt teacher-forced decoder, recipe batch 50", 50, 1024, 512, False),
    # the eval CLIs' (phase_eval_clis): the BiLSTM NMT over the recipe's 10
    # test images at beam 15, and the --image_folder route's 4 images
    # (denseatt at beam 5, then the NMT)
    ("nmt encoder, per direction, eval CLIs' 10 images", 10, 512, 256,
     False),
    ("nmt decoder, eval CLIs' beam 15 x 10", 150, 1024, 512, False),
    ("denseatt lstm0/1/2, --image_folder beam 5 x 4", 20, 1024, 512, True),
    ("nmt encoder, per direction, --image_folder 4 images", 4, 512, 256,
     False),
    ("nmt decoder, --image_folder beam 15 x 4", 60, 1024, 512, False),
]
# (label, B, kb, L, T, S, d, d_ff, heads, lazy anc + want_attn): the decoder
# step at the transformer pivot's two beams and at one beam over the SCST
# batch (its sample and greedy decodes); then 2-layer stacks at head
# widths 96 and 256, at 32 beams of dh 256, and at head widths 6, 50 (with
# a d_ff of 510) and 512
TFD_SHAPES = [
    ("caption beam 5 x 50", 50, 5, 6, 16, 196, 512, 512, 8, False),
    ("nmt beam 15 x 50", 50, 15, 6, 20, 16, 512, 2048, 8, True),
    ("caption greedy / sample, batch 50", 50, 1, 6, 16, 196, 512, 512, 8,
     False),
    ("caption beam 5 x 50, dh 96", 50, 5, 2, 16, 196, 768, 768, 8, False),
    ("caption beam 5 x 50, dh 256", 50, 5, 2, 16, 196, 512, 512, 2, False),
    ("nmt beam 15 x 50, dh 256", 50, 15, 2, 20, 16, 512, 2048, 2, True),
    ("beam 32 x 8 over 196 slots, dh 256", 8, 32, 2, 16, 196, 512, 512, 2,
     True),
    ("caption beam 5 x 50, dh 6", 50, 5, 2, 16, 196, 12, 12, 2, False),
    ("nmt beam 15 x 50, dh 50, d_ff 510", 50, 15, 2, 20, 16, 100, 510, 2,
     True),
    ("caption beam 5 x 50, dh 512", 50, 5, 2, 16, 196, 512, 512, 1, False),
    ("caption beam 3 x 50 (the recipe's eval)", 50, 3, 6, 16, 196, 512,
     512, 8, False),
    ("caption beam 5 x 10 (eval_paired on the recipe's run)", 10, 5, 6, 16,
     196, 512, 512, 8, False),
    # one head past the widths a block held whole (TFD_REFUSAL_SHAPE's
    # first refused width was 7,249 before: q in column chunks), and one
    # too wide for the cross-attention's pieces over 500 slots (a row a
    # block)
    ("one head of 7,300, B 2, 2 beams, 8 slots", 2, 2, 2, 8, 8, 7300, 64,
     1, False),
    ("one head of 6,000 over 500 slots", 2, 2, 2, 8, 500, 6000, 64, 1,
     True),
    # diverse beam groups on the transformer captioner (beam 4 in 2 groups,
    # time-staggered rows) over 50 and 4 images (phase_nmt_extras)
    ("caption beam 4 x 50, diverse groups", 50, 4, 6, 16, 196, 512, 512, 8,
     False),
    ("caption beam 4 x 4, diverse groups", 4, 4, 6, 16, 196, 512, 512, 8,
     False),
]
# (B, beams, S, T, heads, d_ff) of the `--times tfd` reading of the first
# head width the step refuses (none: every width runs)
TFD_REFUSAL_SHAPE = (2, 2, 8, 8, 1, 64)
# the CUDA kernels the decoder-step wrappers launch, by name
TFD_KERNELS = ("decode_gemm_kernel", "decode_gemm_bf16_kernel",
               "ln_rows_kernel", "self_attn_kernel", "cross_attn_kernel",
               "head_mean_kernel")
# every CUDA kernel of csrc/, by name
HAND_KERNELS = LSTM_KERNELS + ("topk_select_kernel",) + TFD_KERNELS
# beams wider than 16 (PERF.md §4 row 1 at wider beams): caption beam 20 ->
# NMT beam 32 through the chunked top-k; NMT beam 40 through the sort route
WIDE_CAP_BEAM, WIDE_NMT_BEAM, SORT_NMT_BEAM = 20, 32, 40
# (label, R, V, k): the chunked top-k at the wide beams' rows, and k = 64
CHUNKED_SHAPES = [
    ("nmt beam 32 x 50", 1600, 8571, 32),
    ("caption beam 20 x 50", 1000, 9488, 20),
    ("caption beam 32 x 50", 1600, 9488, 32),
    ("k=64", 256, 16384, 64),
]

# BiLSTM NMT XE training at bench width (bench.py:205-208): batch 50,
# sources of up to 16 tokens, targets of 18 (BOS ... EOS, PAD-padded),
# dropout 0.3, the config's SGD at learning rate 1 with the clip at 5
NMT_TRAIN = dict(vocab_size=0, nmt_src_vocab_size=11986,
                 nmt_tgt_vocab_size=8571, word_vec_size=512, rnn_size=512,
                 layers=1, brnn=True, dropout=0.3, batch_size=50,
                 i2t_train_flag=False, nmt_train_flag=True, seed=0,
                 dtype="float32")
NMT_SRC_LEN, NMT_TGT_LEN = 16, 18
NMT_EOS = 3
# lstm_cell launches a step: each encoder direction over 16 positions, the
# decoder over 17 inputs (the cell's backward launches nothing)
NMT_CELLS = 2 * NMT_SRC_LEN + NMT_TGT_LEN - 1
# the joint step: denseatt XE training (DTRAIN) and the NMT above in one
# backward, with Weight_Trans over JOINT_ROWS shared rows, Weight_Trans_y
# against a frozen random table and KLD against a frozen random teacher
JOINT_TRAIN = dict(DTRAIN, **{k: NMT_TRAIN[k] for k in (
    "nmt_src_vocab_size", "nmt_tgt_vocab_size", "word_vec_size", "layers",
    "brnn", "dropout", "nmt_train_flag")}, nmt_kld_train_flag=True)
JOINT_ROWS = 3000
# transformer NMT XE training at bench width (bench.py:317-320): d 512,
# d_ff 2048, 6 + 6 layers, 8 heads, batch 50, Adam
TNMT_TRAIN = dict(NMT_TRAIN, nmt_model_type="transformer", rnn_size=2048,
                  layers=6, num_heads=8, dropout=0.1, nmt_optim="adam",
                  nmt_learning_rate=5e-4)
NMT_ROUTES = [("BiLSTM NMT", (False,), TRAIN_STEPS,
               {"lstm_cell": NMT_CELLS})]
# denseatt 3 * 17 cells, the NMT's and the teacher's forward
JOINT_ROUTES = [("joint denseatt + BiLSTM NMT", (False,), TRAIN_STEPS,
                 {"lstm_cell": 3 * _T1 + 2 * NMT_CELLS})]
# SCST at bench.py's point (bench.py:137-158; the transformer's widths
# bench.py:268-274): the df table of a seeded corpus of SCST_IMAGES images
# x SCST_REFS captions of 8-16 words, word ranks drawn as in text (p ~
# 1 / rank), the batch's gts [50, 5, 16] its first 50 images. Random
# weights never end a decode early: 16 steps a decode.
SCST_IMAGES, SCST_REFS = 2000, 5
SCST_TOL = 1e-5   # rewards card vs CPU: |diff| <= SCST_TOL * max(1, |cpu|)
SCST_AGREE_IMAGES = 4  # the greedy baseline decode card vs CPU
_T = CAP["seq_length"]
# (label, flags, timed steps, launches a step): the sample and the greedy
# baseline (3 cells or one decoder-stack call a decode step) and the
# recompute (3 cells an input; the transformer's runs no kernel of csrc/)
SCST_ROUTES = [("denseatt SCST", (False,), ROUTE_STEPS,
                {"lstm_cell": 3 * _T * 3}),
               ("transformer SCST", (True, False), ROUTE_STEPS,
                {"transformer_decode_stack": 2 * _T})]
SCST_JOINT_ROUTE = ("joint denseatt SCST + BiLSTM NMT", (False,), 2,
                    {"lstm_cell": 3 * _T * 3 + 2 * NMT_CELLS})
# (label, B, T, d, d_ff, heads): the whole encoder layer (B6) at the
# transformer captioner's training shape (196 slots, image 1 padded past
# 150) and at the transformer NMT's (sources of 6-16 tokens padded to 16)
ENC_LAYER_SHAPES = [
    ("captioner encoder", 50, 196, 512, 512, 8),
    ("transformer NMT encoder", 50, NMT_SRC_LEN, 512, 2048, 8),
    ("captioner encoder, dh 96", 50, 196, 768, 768, 8),
    ("captioner encoder, dh 256", 50, 196, 512, 512, 2),
    ("captioner encoder, dh 50", 50, 196, 100, 100, 2),
    ("captioner encoder, dh 384, d_ff 510", 50, 196, 384, 510, 1),
    ("captioner encoder, d 4,096 on two images", 2, 196, 4096, 4096, 8),
    # the recipe's transformer XE: 50 images x 5 captions, features repeated
    ("captioner encoder, recipe batch 50 x 5", 250, 196, 512, 512, 8),
]
# transformers at head widths the kernels took only since their widening
# (label, d, heads, d_ff): a training step on each route and a decode, card
# vs CPU, at HW_LAYERS layers
HEAD_WIDTHS = [("dh 96", 768, 8, 768), ("dh 256", 512, 2, 512),
               ("dh 6", 12, 2, 12), ("dh 50", 100, 2, 100),
               ("dh 384", 384, 1, 384), ("dh 512", 512, 1, 512),
               ("d_ff 510", 512, 8, 510), ("d 30", 30, 5, 45)]
HW_LAYERS = 2
# (label, d, d_ff, heads): the whole decoder layer (B7) at the captioner's
# training shape (T 17 over S 196), at head widths 64, 96 and 256
DEC_LAYER_SHAPES = [
    ("captioner decoder", 512, 512, 8),
    ("captioner decoder, dh 96", 768, 768, 8),
    ("captioner decoder, dh 256", 512, 512, 2),
    ("captioner decoder, dh 384, d_ff 510", 384, 510, 1),
]
TNMT_ROUTES = [("transformer NMT, default (whole encoder layers)",
                (True, False), ROUTE_STEPS,
                _per_step(enc=_L, mha=2 * _L, ln=3 * _L + 2))]

# (label, R, V, k): beam selection rows of the path, then the k domain edges
TOPK_SHAPES = [
    ("caption beam 5 x 50", 250, 9488, 5),
    ("nmt beam 15 x 50", 750, 8571, 15),
    ("caption beam 3 x 50", 150, 9488, 3),
    ("k=1", 250, 9488, 1),
    ("k=2", 250, 9488, 2),
    ("k=16", 250, 9488, 16),
    # the eval CLIs' (phase_eval_clis): 10 test images, and 4 raw images
    ("caption beam 5 x 10", 50, 9488, 5),
    ("nmt beam 15 x 10", 150, 8571, 15),
    ("caption beam 5 x 4", 20, 9488, 5),
    ("nmt beam 15 x 4", 60, 8571, 15),
    # the back-translation of phase_raw_data: 10 lines at beam 5
    ("nmt beam 5 x 10", 50, 8571, 5),
]

# `--times`: the groups of kernels it times (the top-k, the training
# attention, the additive attentions B9a-c, the decoder step, the training
# LayerNorm and B6's backward by kind, the image front end), the calls
# each reading averages, and the head counts at d 512 (head widths 32, 64
# and 128) of the training attention and the decoder step
TIMES_GROUPS = ("topk", "mha", "att", "tfd", "ln", "img", "bf16", "steps")
TIMES_ITERS = 50
WALL_ITERS = 10   # back-to-back calls of each per-call wall time (time_pair)
TIMES_HEADS = (16, 8, 4)

# the raw-image path: 16 images of two sizes -> 448 x 448 -> ResNet-101 ->
# fc [2048] and att [14 x 14, 2048] (the JAX config's image_size and
# resnet_depth), then the LSTM pivot
IMG_SIZE, ATT_SIZE, RAW_BATCH, RAW_TIMED = 448, 14, 16, 3
RAW_SHAPES = [(375, 500), (480, 640)]
# B11's checks: a general downscale and the loader's identity size
IMG_CASES = [("downscale", 16, 480, 640, 448),
             ("loader identity", 16, 448, 448, 448),
             ("loader identity, eval_pivot's 4 images", 4, 448, 448, 448)]
IMG_TOL = 1e-4    # max|diff| <= IMG_TOL * max(1, max|plain|): two-tap sums
# in another order than the dense products
# B11 at widths off the path (checked, not timed): rows of Wo * C not whole
# float4 (the general instance's head, body and tail), one and four
# channels, the identity at such a width (bit-equal to the host), and rows
# too long to stage in shared memory: (label, B, H, W, C, Ho, Wo)
IMG_WIDTHS = [("Wo * C = 69", 2, 31, 45, 3, 17, 23),
              ("one channel", 2, 19, 23, 1, 13, 17),
              ("four channels", 3, 20, 30, 4, 15, 18),
              ("identity, Wo * C = 51", 3, 21, 17, 3, 21, 17),
              ("rows of 120,000 bytes", 1, 3, 40000, 3, 2, 39999)]
CONV_KERNEL_WORDS = ("conv", "fprop", "xmma", "implicit", "winograd", "gemm",
                     "cudnn", "cutlass")
# B9a-c where one query's A and D do not fit a block (A + D = 64,000 over
# N 8; checked, not timed): (B, N, A, D, K beams, H of B9c)
ATT_WIDE = [(5, 8, 32000, 32000, 5, 8), (5, 8, 31999, 32001, 5, 8)]
# B10: the lstm0 fragment (tools/perf/ab_lstm_block.py): B, T, D, H
CHAIN_SHAPE = (50, 17, 1024, 512)
CHAIN_TOL = 1e-4  # each output: max|diff| <= CHAIN_TOL * max(1, max|plain|)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time per call over `iters` back-to-back calls, from CUDA events:
    it includes the host's launch overhead wherever the host, not the card,
    is the slower of the two."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile_device_us(run, attempts: int = 2):
    """Run `run()` under torch.profiler and return, for each CUDA kernel
    name, its device time in microseconds and its launch count. A session
    that records no device event is repeated once; after that the result is
    None and the caller times with CUDA events instead.

    Once a process has run many sessions, the profiler loses the first
    device events of each new one (H100, torch 2.11: the raw-image batch
    lost its upload and B11). So every session opens with LEAD_IN short
    spin kernels, which take that loss and are left out of the result;
    `LEAD_IN_SEEN` keeps how many of them each session recorded and the
    name of the first other event it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        per_name: dict = {}
        lead = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                lead += 1
                continue
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        LEAD_IN_SEEN.append((lead, next(iter(per_name), "")))
        if per_name:
            return per_name
    return None


def log_lead_in() -> None:
    """How many of the sessions' lead-in events the profiler lost: a session
    that lost all of them may have lost events of the run it measured."""
    lost = [LEAD_IN - n for n, _ in LEAD_IN_SEEN]
    all_lost = [short_name(first)[:40] for n, first in LEAD_IN_SEEN if n == 0]
    log(f"profiler: {len(lost)} sessions, each opened by {LEAD_IN} spin "
        f"kernels; lost {sum(lost)} of them, at most {max(lost, default=0)} "
        f"in one session, none in {lost.count(0)} sessions; sessions that "
        f"lost all {LEAD_IN}: {len(all_lost)}"
        + (f" (first events recorded: {', '.join(all_lost)})"
           if all_lost else ""))


def device_ms(fn):
    """Device time of one call of `fn` (after one warm-up call): (the summed
    durations of the CUDA kernels it launches, as torch.profiler records
    them, in ms; the per-kernel-name (us, launches)), or (None, None) if the
    profiler recorded none. Unlike `time_ms` it leaves out the host's launch
    overhead."""
    fn()
    per_name = _profile_device_us(fn)
    if per_name is None:
        return None, None
    return sum(us for us, _ in per_name.values()) / 1e3, per_name


def library_ms(fn, iters: int = 10, parts: dict = None):
    """Device time per call of `fn`, a PyTorch yardstick call or a kernel
    timed alone (summed CUDA kernel time under torch.profiler over `iters`
    calls, after one warm-up), and
    how it was read; CUDA-event time if the profiler records none. A
    `parts` dict receives the device ms per call by CUDA kernel name."""
    fn()
    per_name = _profile_device_us(lambda: [fn() for _ in range(iters)])
    if per_name is None:
        return time_ms(fn, iters), "CUDA events, no profiler data"
    if parts is not None:
        for name, (us, _) in per_name.items():
            key = short_name(name)
            parts[key] = parts.get(key, 0.0) + us / iters / 1e3
    return sum(us for us, _ in per_name.values()) / iters / 1e3, "device"


def bound(nbytes: float, flops: float, transcendentals: float = 0.0):
    """(least time in ms, what bounds it): the largest of the bytes over the
    card's memory rate, the f32 operations over its f32 peak and the
    transcendental evaluations over its special-function rate (SFU_RATE)."""
    terms = [(nbytes / HBM_BYTES_S * 1e3, "bytes"),
             (flops / F32_FLOPS * 1e3, "operations")]
    if transcendentals:
        terms.append((transcendentals / SFU_RATE[0] * 1e3,
                      "transcendentals"))
    return max(terms, key=lambda t: t[0])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def short_name(name: str) -> str:
    """A CUDA kernel's name without its namespace and parameter list."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def time_pair(kernel_fn, plain_fn, kernel_name, iters: int = 10,
              parts: dict = None):
    """Kernel and plain times, taken in turns: (kernel ms, plain ms, kernel
    wall ms per call, plain wall ms per call, how the first two were read).
    The first two are device times from one profiler session in which the
    two alternate, the kernel's events told apart by `kernel_name` (a name
    or a tuple of names); if the profiler records no device time they are
    the CUDA-event times. Wall times come from CUDA events around
    back-to-back calls (plain, kernel, kernel, plain). A `parts` dict
    receives the kernel's device time per call by CUDA kernel name:
    {short name: (ms, launches)}."""
    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
    kernel_fn()
    plain_fn()

    def run():
        for _ in range(iters):
            plain_fn()
            kernel_fn()

    per_name = _profile_device_us(run) or {}
    mine = {n for n in per_name if any(k in n for k in names)}
    k_us = sum(us for n, (us, _) in per_name.items() if n in mine)
    p_us = sum(us for n, (us, _) in per_name.items() if n not in mine)
    if parts is not None:
        for n in mine:
            us, count = per_name[n]
            ms0, c0 = parts.get(short_name(n), (0.0, 0.0))
            parts[short_name(n)] = (ms0 + us / iters / 1e3,
                                    c0 + count / iters)
    p1, k1, k2, p2 = (time_ms(f, WALL_ITERS) for f in (
        plain_fn, kernel_fn, kernel_fn, plain_fn))
    k_wall, p_wall = (k1 + k2) / 2, (p1 + p2) / 2
    if k_us > 0 and p_us > 0:
        return k_us / iters / 1e3, p_us / iters / 1e3, k_wall, p_wall, "device"
    return k_wall, p_wall, k_wall, p_wall, "CUDA events, no profiler data"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    CARD[:] = [card]
    log(card)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_RATE[:] = [SFU_PER_SM_CLOCK * sms * float(clock) * 1e6]
    log(f"special-function rate: {SFU_PER_SM_CLOCK} a clock x {sms} SMs x "
        f"{clock} MHz (max SM clock) = {SFU_RATE[0] / 1e12:.3f} T/s")
    log(f"device: {torch.cuda.get_device_name(0)} | count "
        f"{torch.cuda.device_count()} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")


def phase_build() -> None:
    from unpaired_image_captioning_tpu_torch.kernels import build

    build.load()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build: {build.build_seconds:.1f} s (nvcc, sm_90a)")
    for ln in ptxas:
        log(f"  ptxas {ln}")


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    kernels' records for the JSON line."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import build
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk

    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    lstm_err, lstm_rows = 0.0, []
    for label, b, d, h, maxout in LSTM_SHAPES:
        g = 5 if maxout else 4
        scale = 1.0 / h ** 0.5
        w = (torch.rand((d + h, g * h), generator=gen, device=dev) * 2 - 1) * scale
        bias = (torch.rand((g * h,), generator=gen, device=dev) * 2 - 1) * scale
        x = torch.randn((b, d), generator=gen, device=dev)
        h0 = torch.randn((b, h), generator=gen, device=dev)
        c0 = torch.randn((b, h), generator=gen, device=dev)
        before = lk.launches
        hk, ck = lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout)
        if lk.launches != before + 1:
            raise AssertionError(f"lstm_cell {label}: {lk.launches - before}"
                                 " launches for one call")
        hp, cp = lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout)
        torch.cuda.synchronize()
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        if not err <= LSTM_TOL:
            raise AssertionError(f"lstm_cell {label}: max|diff| {err} > {LSTM_TOL}")
        # both against the plain version in f64: the kernel's f32 sums
        # against cuBLAS's
        h64, c64 = lk.lstm_cell_plain(*(t.double() for t in (w, bias, x, h0,
                                                             c0)),
                                      maxout=maxout)
        e64 = [max((hh.double() - h64).abs().max().item(),
                   (cc.double() - c64).abs().max().item())
               for hh, cc in ((hk, ck), (hp, cp))]
        pl = lk.plan(b, d, h)
        tile = ("wide, 4 x 4 x G" if pl["bn"] == 32
                else "narrow, 4 x 2 x G") + " f32 FMA register tiles"
        log(f"lstm_cell G={g} [{b}, {d}->{h}]: plan {pl['bn']} units a tile"
            f" ({tile}), cluster {pl['cluster']} ({pl['k_rows']} rows"
            f" of K a block), {pl['blocks']} blocks")
        k_ms, p_ms, k_wall, p_wall, how = time_pair(
            lambda: lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout),
            lambda: lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout),
            LSTM_KERNELS)
        alone = None
        if pl["cluster"] > 1:
            # the same tile without the cluster: the choice's yardstick
            ho, co = torch.empty_like(h0), torch.empty_like(c0)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def unclustered():
                build.check(build.load().lstm_cell_f32_unclustered(
                    x.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(),
                    bias.data_ptr(), ho.data_ptr(), co.data_ptr(), b, d, h,
                    g, stream), "lstm_cell_f32_unclustered")

            unclustered()
            e1 = max((ho - hp).abs().max().item(),
                     (co - cp).abs().max().item())
            if not e1 <= LSTM_TOL:
                raise AssertionError(f"lstm_cell {label} without the "
                                     f"cluster: max|diff| {e1} > {LSTM_TOL}")
            alone = library_ms(unclustered)[0]
        # each input read once, each output written once; 2 FLOP a MAC
        b_ms, b_by = bound(nbytes(w, bias, x, h0, c0, hk, ck),
                           2.0 * b * (d + h) * g * h)
        lib_ms, lib_msg = None, "no single PyTorch call (maxout cell)"
        if g == 4:
            # torch.lstm_cell takes (i, f, g, o) gate blocks in [4H, in]
            # weights; the port's are (i, f, o, g) in [in, 4H]. Permuted
            # once here, outside the timing.
            blk = [torch.arange(j * h, (j + 1) * h, device=dev)
                   for j in (0, 1, 3, 2)]
            cols = torch.cat(blk)
            w_ih = w[:d, cols].t().contiguous()
            w_hh = w[d:, cols].t().contiguous()
            b_ih, b_hh = bias[cols].contiguous(), torch.zeros_like(bias)

            def lib():
                return torch.lstm_cell(x, (h0, c0), w_ih, w_hh, b_ih, b_hh)

            hl, cl = lib()
            lib_err = max((hl - hp).abs().max().item(),
                          (cl - cp).abs().max().item())
            lib_ms, lib_how = library_ms(lib)
            lib_msg = (f"torch.lstm_cell on permuted weights {lib_ms:.4f} ms "
                       f"({lib_how}; max|diff| vs plain {lib_err:.3g})")
        lstm_err = max(lstm_err, err)
        lstm_rows.append(dict(label=label, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                              timing=how, shape=f"G={g} [{b}, {d}->{h}]",
                              plan=pl, no_cluster_ms=alone,
                              f64_err=e64[0], plain_f64_err=e64[1]))
        log(f"kernel lstm_cell G={g} [{b}, {d}->{h}] ({label}): "
            f"max|diff| {err:.3g} (tol {LSTM_TOL}; against f64: kernel "
            f"{e64[0]:.3g}, plain f32 {e64[1]:.3g}); {how}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per call kernel "
            f"{k_wall:.4f} ms, plain {p_wall:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}); library: {lib_msg}"
            + (f"; without the cluster {alone:.4f} ms" if alone else ""))
    # the record's numbers: the NMT decoder's G=4 cell (it has a library
    # yardstick); every shape is in "shapes"
    main = next(r for r in lstm_rows if r["label"].startswith("nmt decoder"))
    rec["lstm_cell"] = {
        "name": "lstm_cell", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/rnn.py:72",
        "max_abs_err": lstm_err, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": f"{main['label']}: {main['shape']}",
        "timing": main["timing"], "shapes": lstm_rows}

    topk_rows = []
    for label, r, v, k, x in _topk_cases(dev, TOPK_SHAPES, _beam_rows):
        vk, ik = tk.row_topk(x, k)
        vp, ip = tk.row_topk_plain(x, k)
        torch.cuda.synchronize()
        _same_topk(f"row_topk {label}", (vk, ik), (vp, ip))
        k_ms, p_ms, k_wall, p_wall, how = time_pair(
            lambda: tk.row_topk(x, k), lambda: tk.row_topk_plain(x, k),
            "topk_select_kernel")
        # one f32 comparison an element; the row is read once
        b_ms, b_by = bound(nbytes(x, vk, ik), float(r * v))
        # torch.topk: the same values, with no promise on the order of ties
        lib_ms, lib_how = library_ms(lambda: torch.topk(x, k, dim=1))
        lib_same = torch.equal(torch.topk(x, k, dim=1).values, vp)
        topk_rows.append(dict(label=label, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                              timing=how, shape=f"[{r}, {v}] k={k}"))
        log(f"kernel row_topk [{r}, {v}] k={k} ({label}): exact "
            f"(values and indices equal, NaN rows too); {how}: kernel "
            f"{k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms; per call kernel {k_wall:.4f} ms, "
            f"plain {p_wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}); library "
            f"torch.topk {lib_ms:.4f} ms ({lib_how}; values equal: "
            f"{lib_same})")
    main = topk_rows[0]
    rec["row_topk"] = {
        "name": "row_topk", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/topk_select.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/topk.py:145",
        "max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"{main['label']}: {main['shape']}",
        "timing": main["timing"], "shapes": topk_rows}
    return rec


def _beam_rows(x, k: int) -> None:
    """Overwrite the first rows of x [R, V] with the rows a beam search
    meets: exact ties, all -inf rows, -inf tails, dead beam rows, g rows
    of each (4g of ties; g = 5, or 2 where R < 40); then the NaN rows of
    `_nan_rows`."""
    import torch

    r, v = x.shape
    g = 5 if r >= 40 else 2
    if r < 7 * g + 5:
        raise ValueError(f"_beam_rows: {r} rows hold no special rows")
    t = 4 * g
    x[:t] = torch.round(x[:t] * 2) / 2                # many exact ties
    x[t:t + g] = float("-inf")                        # all -inf rows
    x[t + g:t + 2 * g] = float("-inf")                # -inf tails
    x[t + g:t + 2 * g, 7] = 1.0
    x[t + g:t + 2 * g, v - 1] = 1.0
    x[t + 2 * g:t + 3 * g] = -1e10                    # dead beam rows
    _nan_rows(x, t + 3 * g, k)                        # NaN (C2)


def _topk_cases(dev, shapes, special):
    """(label, R, V, k, x) for each (label, R, V, k) of `shapes`: randn rows
    from a seed of their own (the shape's place in the list), the first
    rows overwritten by `special(x, k)`."""
    import torch

    for i, (label, r, v, k) in enumerate(shapes):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        x = torch.randn((r, v), generator=gen, device=dev)
        special(x, k)
        yield label, r, v, k, x


def _nan_rows(x, r0: int, k: int) -> None:
    """Rows r0 .. r0 + 4 of x [R, V] with NaN, which ranks above +inf (NaN
    among NaN by index): scattered NaN, NaN beside +-inf, an all-NaN row,
    fewer than k values that are not NaN, fewer than k finite values (the
    rest -inf)."""
    import torch

    v = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(r0 + k)
    nan = float("nan")
    x[r0, torch.rand(v, generator=g, device=x.device) < 0.02] = nan
    x[r0 + 1, 3 * k:6 * k] = float("inf")
    x[r0 + 1, 10 * k:12 * k] = float("-inf")
    x[r0 + 1, 7:7 + k // 2 + 1] = nan
    x[r0 + 2] = nan
    x[r0 + 3] = nan
    x[r0 + 3, 11:11 + k // 2] = 1.0
    x[r0 + 4] = float("-inf")
    x[r0 + 4, 5:5 + k - 1] = 2.0


def _same_topk(name: str, got, want) -> None:
    """Raise unless the indices are equal and the values are, NaN where
    NaN."""
    import torch

    (gv, gi), (wv, wi) = got, want
    nan = torch.isnan(wv)
    if (torch.equal(gi, wi) and torch.equal(torch.isnan(gv), nan)
            and torch.equal(torch.where(nan, 0.0, gv),
                            torch.where(nan, 0.0, wv))):
        return
    bad = ((gi != wi) | (torch.isnan(gv) != nan)).any(dim=1)
    raise AssertionError(f"{name}: differs from the plain version in rows "
                         f"{bad.nonzero()[:5, 0].tolist()}")


def _breaking_rows(x, k: int) -> None:
    """Overwrite the first rows of x [R, V] with rows built to break a
    naive chunked top-k: ties, one chunk holding most of the top k, equal
    values straddling chunk boundaries, -inf / +inf entries, an all -inf
    row; then the NaN rows of `_nan_rows`."""
    import torch

    v = x.shape[1]
    x[0:4] = torch.round(x[0:4] * 2) / 2
    x[4] = -10.0
    x[4, 256:256 + k - 2] = 100.0 - 0.5 * torch.arange(k - 2, device=x.device)
    x[4, 5], x[4, v - 3] = 95.0, 94.5
    x[5] = -1.0
    for c in range(1, k + 4):
        x[5, c * 128 - 1:c * 128 + 1] = 7.0
    x[5, 40] = 9.0
    x[6] = float("-inf")
    x[6, 7:7 + k // 2] = 1.0
    x[6, 3] = float("inf")
    x[7] = float("-inf")
    _nan_rows(x, 8, k)


def phase_chunked_topk(dev) -> dict:
    """The chunked top-k kernel against its plain version at the wide
    beams' shapes: values and indices exactly equal; device times beside
    the plain version's, the bound and torch.topk's. Returns the kernel's
    record for the JSON line."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck

    rows = []
    for label, r, v, k, x in _topk_cases(dev, CHUNKED_SHAPES, _breaking_rows):
        vk, ik = ck.chunked_topk(x, k)
        vp, ip = ck.chunked_topk_plain(x, k)
        torch.cuda.synchronize()
        _same_topk(f"chunked_topk {label}", (vk, ik), (vp, ip))
        k_ms, p_ms, k_wall, p_wall, how = time_pair(
            lambda: ck.chunked_topk(x, k), lambda: ck.chunked_topk_plain(x, k),
            "topk_select_kernel")
        # the row is read once and the outputs written once; one f32
        # comparison an element
        b_ms, b_by = bound(nbytes(x, vk, ik), float(r * v))
        lib_ms, lib_how = library_ms(lambda: torch.topk(x, k, dim=1))
        rows.append(dict(label=label, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, timing=how,
                         shape=f"[{r}, {v}] k={k}"))
        log(f"kernel chunked_topk [{r}, {v}] k={k} ({label}): exact (values "
            f"and indices equal, -inf / +inf clamped, NaN kept); {how}: "
            "kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per call kernel "
            f"{k_wall:.4f} ms, plain {p_wall:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}); library torch.topk {lib_ms:.4f} ms ({lib_how})")
    main = rows[0]
    return {"chunked_topk": {
        "name": "chunked_topk", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/topk_select.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/topk.py:278",
        "max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"{main['label']}: {main['shape']}",
        "timing": main["timing"], "shapes": rows}}


def phase_times(dev, groups) -> list:
    """`--times`: the device time per call of the kernels of `groups`
    (`TIMES_GROUPS`), averaged over TIMES_ITERS calls, on inputs made as
    their checks make them; no check, no plain version. Returns the
    readings."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    readings = []

    def rec(kernel, shape, fn):
        parts = {}
        ms, how = library_ms(fn, TIMES_ITERS, parts)
        readings.append(dict(kernel=kernel, shape=shape, ms=ms, timing=how,
                             parts=parts))
        log(f"time {kernel} [{shape}]: {ms:.4f} ms ({how}); by CUDA kernel: "
            + ", ".join(f"{n} {v:.4f}" for n, v in sorted(
                parts.items(), key=lambda kv: -kv[1])))
        return readings[-1]

    if "topk" in groups:
        for label, r, v, k, x in _topk_cases(dev, TOPK_SHAPES, _beam_rows):
            rec("row_topk", f"[{r}, {v}] k={k} ({label})",
                lambda: tk.row_topk(x, k))
        for label, r, v, k, x in _topk_cases(dev, CHUNKED_SHAPES,
                                            _breaking_rows):
            rec("chunked_topk", f"[{r}, {v}] k={k} ({label})",
                lambda: ck.chunked_topk(x, k))
    if "mha" in groups:
        gen = torch.Generator(device=dev).manual_seed(3)
        seed = torch.tensor([4321], dtype=torch.int32, device=dev)
        d = TCAP["input_encoding_size"]
        for label, b, t, s, kind in MHA_SHAPES[:3]:   # the step's shapes
            q, k, v, g, maskadd = _mha_inputs(dev, gen, b, t, s, kind, d)
            for heads in TIMES_HEADS:
                kw = dict(n_heads=heads, rate=TRAIN_RATE)
                out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
                shape = f"{label}, dh {d // heads}"
                rec("mha_train_fwd", shape, lambda: mhk.mha_train_fwd(
                    q, k, v, maskadd, seed, **kw))
                rec("mha_train_bwd", shape, lambda: mhk.mha_train_bwd(
                    q, k, v, maskadd, seed, g, out, stats, **kw))
    if "att" in groups:
        gen = torch.Generator(device=dev).manual_seed(7)
        args = _att_inputs(dev, gen)
        rec("additive_attention", "B9a, K=1",
            lambda: aak.additive_attention(*args))
        for k in ATT_BEAMS:
            args_k = _att_inputs(dev, gen, k)
            rec("additive_attention_beams", f"B9b, K={k}",
                lambda: aak.additive_attention_beams(*args_k))
        step = _step_args(dev, gen)
        with torch.no_grad():
            rec("att_lstm_att", "B9c", lambda: aak.fused_att_lstm_att(*step))
    if "tfd" in groups:
        gen = torch.Generator(device=dev).manual_seed(1)
        for label, b, kb, n_l, n_t, slots, d, dff, _, lazy in TFD_SHAPES[:2]:
            a = _tfd_inputs(dev, gen, b, kb, n_l, n_t, slots, d, dff, lazy)
            for heads in TIMES_HEADS:
                rec("transformer_decode_stack", f"{label}, dh {d // heads}",
                    lambda: tdk.decoder_stack_step(
                        a["x"], a["t"], a["ck"], a["cv"], a["mask"], a["kc"],
                        a["vc"], a["w"], a["anc"], n_heads=heads,
                        want_attn=lazy))
        b, kb, slots, n_t, heads, dff = TFD_REFUSAL_SHAPE
        first = _first_refused_width(
            lambda dh: tdk._check_dims("step", b * kb, b, dh * heads, dff,
                                       heads, slots, n_t))
        readings.append(dict(kernel="transformer_decode refusal", shape=(
            f"B {b}, {kb} beams, S {slots}, T {n_t}, {heads} head(s)"),
            first_refused_dh=first))
        log(f"transformer_decode at {readings[-1]['shape']}: first head "
            f"width the step refuses: {first}")
    if "ln" in groups:
        from unpaired_image_captioning_tpu_torch.kernels import (
            layer_train as ltk)
        from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk

        gen = torch.Generator(device=dev).manual_seed(3)
        for label, b, t, d in LN_SHAPES:
            x, scale, offset, g = _ln_inputs(dev, gen, b, t, d)
            shape = f"[{b}, {t}, {d}] ({label})"
            rec("ln_train_fwd", shape,
                lambda: lnk.ln_train_fwd(x, scale, offset))
            rec("ln_train_bwd", shape, lambda: lnk.ln_train_bwd(x, scale, g))
        # B6's encoder layer backward at the captioner's shape, by kind
        label, b, s, d, f, heads = ENC_LAYER_SHAPES[0]
        x, g, _, maskadd, seed, w, _ = _enc_layer_inputs(dev, gen, b, s, d, f)
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        _, saved = ltk.enc_layer_fwd(x, maskadd, seed, w, **kw)
        r = rec("enc_layer_train_bwd", label, lambda: ltk.enc_layer_bwd(
            x, maskadd, seed, w, saved, g, **kw))
        r["by_kind_ms"] = {
            kind: sum(v for n, v in r["parts"].items()
                      if any(k in n for k in keys))
            for kind, keys in LAYER_KINDS.items()}
        log(f"time enc_layer_train_bwd [{label}] by kind: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["by_kind_ms"].items()))
    if "bf16" in groups:
        # the default bf16 route's B1 (all bf16) and B6 / B7 at the path
        # shapes, B6 / B7's f32 entries beside them; only the wrappers'
        # calls, so that this script can time an older tree's kernels too
        from unpaired_image_captioning_tpu_torch.kernels import (
            layer_train as ltk)
        from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
        from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

        bf = torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(21)
        for label, b, d, h, maxout in BF16_CELL_SHAPES:
            g = 5 if maxout else 4
            scale = 1.0 / h ** 0.5
            w, bias = ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                       .mul(scale).to(bf) for shape in ((d + h, g * h),
                                                        (g * h,)))
            x, h0, c0 = (torch.randn((b, m), generator=gen, device=dev)
                         .to(bf) for m in (d, h, h))
            shape = f"G={g} [{b}, {d}->{h}] all bf16 ({label})"
            rec("lstm_cell_bf16", shape, lambda: lk.lstm_cell(
                w, bias, x, h0, c0, maxout=maxout))
            if g == 4:
                cols = torch.cat([torch.arange(j * h, (j + 1) * h, device=dev)
                                  for j in (0, 1, 3, 2)])
                w_ih = w[:d, cols].t().contiguous()
                w_hh = w[d:, cols].t().contiguous()
                b_ih, b_hh = bias[cols].contiguous(), torch.zeros_like(bias)
                rec("torch.lstm_cell bf16", shape, lambda: torch.lstm_cell(
                    x, (h0, c0), w_ih, w_hh, b_ih, b_hh))
        # B5's bf16 forward and backward alone at the path shapes, SDPA on
        # the same bf16 tensors beside them (at rate 0; the port never calls
        # it), and their bound
        import torch.nn.functional as F

        seed = torch.tensor([4321], dtype=torch.int32, device=dev)
        d, heads = TCAP["input_encoding_size"], TCAP["num_heads"]
        dh = d // heads
        for label, b, t, s_, kind in BF16_MHA_SHAPES:
            q, k, v, g, maskadd = _mha_inputs(dev, gen, b, t, s_, kind, d)
            q, k, v, g = (z.to(bf) for z in (q, k, v, g))
            kw = dict(n_heads=heads, rate=TRAIN_RATE)
            out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
            grads = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                                      **kw)
            pairs = float((maskadd >= 0).expand(b, t, s_).sum()) * heads
            q4, k4, v4, g4 = (z.view(b, z.shape[1], heads, dh).transpose(1, 2)
                              for z in (q, k, v, g))
            m4 = maskadd[:, None].to(bf)
            lq, lk_, lv = (z.detach().requires_grad_() for z in (q4, k4, v4))
            lout = F.scaled_dot_product_attention(lq, lk_, lv, attn_mask=m4)
            for name, fn, lib, by, flops in (
                    ("mha_train_fwd", lambda: mhk.mha_train_fwd(
                        q, k, v, maskadd, seed, **kw),
                     lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, attn_mask=m4),
                     nbytes(q, k, v, maskadd, seed, out, stats),
                     4.0 * pairs * dh),
                    ("mha_train_bwd", lambda: mhk.mha_train_bwd(
                        q, k, v, maskadd, seed, g, out, stats, **kw),
                     lambda: torch.autograd.grad(lout, (lq, lk_, lv), g4,
                                                 retain_graph=True),
                     nbytes(q, k, v, maskadd, seed, g, out, stats, *grads),
                     10.0 * pairs * dh)):
                r = rec(f"{name} bf16", label, fn)
                r["bound_ms"], r["bound_by"] = bound_mixed(by, 0.0, flops)
                r["library_ms"] = rec(f"{name} SDPA bf16, rate 0", label,
                                      lib)["ms"]
                log(f"time {name} bf16 [{label}]: kernel {r['ms']:.4f} ms, "
                    f"SDPA bf16 {r['library_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            del lout, lq, lk_, lv, grads
        for label, b, t, d, f, heads in BF16_ENC_SHAPES:
            x, g, _, maskadd, seed, w, _ = _enc_layer_inputs(dev, gen, b, t,
                                                             d, f)
            kw = dict(n_heads=heads, rate=TRAIN_RATE)
            for dt in (torch.float32, bf):
                xd, gd = x.to(dt), g.to(dt)
                wd = {k: v.to(dt) for k, v in w.items()}
                _, saved = ltk.enc_layer_fwd(xd, maskadd, seed, wd, **kw)
                name = "bf16" if dt == bf else "f32"
                rec(f"enc_layer_train_fwd {name}", label,
                    lambda: ltk.enc_layer_fwd(xd, maskadd, seed, wd, **kw))
                rec(f"enc_layer_train_bwd {name}", label,
                    lambda: ltk.enc_layer_bwd(xd, maskadd, seed, wd, saved,
                                              gd, **kw))
                del saved
        for label, b, t, s_, d, f, heads in BF16_DEC_SHAPES:
            x, g = (torch.randn((b, t, d), generator=gen, device=dev)
                    for _ in range(2))
            mk, mv = (torch.randn((b, s_, d), generator=gen, device=dev)
                      for _ in range(2))
            pos = torch.arange(t, device=dev)
            tmask = torch.where((pos[None, :] <= pos[:, None])[None]
                                .expand(b, t, t), 0.0, -1e9).contiguous()
            keep = torch.ones((b, 1, s_), dtype=torch.bool, device=dev)
            keep[1, :, 150:] = False
            smask = torch.where(keep, 0.0, -1e9).contiguous()
            seeds = torch.tensor([4321, 4321 ^ 0x55555555],
                                 dtype=torch.int32, device=dev)
            w = _layer_weights(gen, dev, lto.DEC_WEIGHTS, d, f)
            kw = dict(n_heads=heads, rate=TRAIN_RATE)
            for dt in (torch.float32, bf):
                a = [v.to(dt) for v in (x, mk, mv)] + [tmask, smask, seeds]
                a.append({k: v.to(dt) for k, v in w.items()})
                gd = g.to(dt)
                _, saved = ltk.dec_layer_fwd(*a, **kw)
                name = "bf16" if dt == bf else "f32"
                rec(f"dec_layer_train_fwd {name}", label,
                    lambda: ltk.dec_layer_fwd(*a, **kw))
                rec(f"dec_layer_train_bwd {name}", label,
                    lambda: ltk.dec_layer_bwd(*a, saved, gd, **kw))
                del saved
    if "tfd" in groups:
        # B4 at the path pairs: the f32 entry, the serving mixture and the
        # all-bf16 step, stack and layer, beside the bound and, all bf16,
        # the step's products alone in bf16 cuBLAS; the tensor-core launches
        # of the timed calls where the tree counts them
        for c in _b4_bf16_cases(dev, torch.Generator(device=dev)
                                .manual_seed(22),
                                (("f32",) * 4,) + BF16_TFD_MIXES):
            counter = ("tc_stack_launches" if c["kind"] ==
                       "decoder_stack_step" else "tc_layer_launches")
            before = getattr(tdk, counter, None)
            fn = getattr(tdk, c["kind"])
            r = rec(c["name"][:-5] + " " + "/".join(c["mix"]), c["label"],
                    lambda f_=fn, c_=c: f_(*c_["args"], **c_["kw"]))
            f32 = c["mix"] == ("f32",) * 4
            r["bound_ms"], r["bound_by"] = bound_mixed(
                c["bytes"], 0.0 if c["all_bf"] else c["flops"],
                c["flops"] if c["all_bf"] else 0.0)
            r["tc_launches"] = (None if before is None
                                else getattr(tdk, counter) - before)
            r["library_ms"] = (rec("its products alone, bf16 cuBLAS",
                                   c["label"], c["lib"])["ms"]
                               if c["lib"] is not None else None)
            log(f"time {c['name'][:-5]} [{c['label']}]: kernel "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}"
                + ("; f32 entry" if f32 else "; bf16 elements 2 bytes")
                + "), bf16 cuBLAS over its products "
                + ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
                + f", tensor-core launches {r['tc_launches']}")
    if "steps" in groups:
        # the transformer captioner's XE step on the default route in f32
        # and in bf16: the host wall of 5 synchronised steps after 2, and one
        # step's device time by CUDA kernel
        from unpaired_image_captioning_tpu_torch.config import Config
        from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

        batch = make_train_batch(np.random.RandomState(43), BENCH_BATCH)
        for dt in ("float32", "bfloat16"):
            tr = Trainer(Config(**dict(TRAIN, dtype=dt)), device=dev)
            for _ in range(2):
                tr.train(batch)
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            parts = {}
            ms, how = library_ms(lambda: tr.train(batch), 1, parts)
            readings.append(dict(kernel="transformer XE step", shape=dt,
                                 walls_ms=walls, ms=ms, timing=how,
                                 parts=parts))
            log(f"time transformer XE step [{dt}, default route, batch "
                f"{BENCH_BATCH}]: walls "
                + ", ".join(f"{w:.1f}" for w in walls)
                + f" ms; device busy {ms:.2f} ms ({how}); by CUDA kernel: "
                + ", ".join(f"{n} {v:.2f}" for n, v in sorted(
                    parts.items(), key=lambda kv: -kv[1])[:8]))
            del tr
            torch.cuda.empty_cache()
        # B4's two bf16 routes end to end: the bf16 transformer SCST step
        # (its sample and greedy decodes through B4, every operand bf16)
        # and one batch-50 transformer pivot over rounded features (B4's f32
        # weights over bf16 memory and caches): host walls after a warm-up
        # and one profiled call's device busy
        from unpaired_image_captioning_tpu_torch.data.dataloader import (
            to_bfloat16)
        from unpaired_image_captioning_tpu_torch.models.base import Features
        from unpaired_image_captioning_tpu_torch.ops.cider import (
            build_df_table)
        from unpaired_image_captioning_tpu_torch.pivot import pivot_translate
        from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
            compute_df)

        labels, start, end = make_scst_corpus(np.random.RandomState(0))
        df, n_img = compute_df(labels, start, end)
        tsc = Trainer(Config(**dict(TRAIN, dtype="bfloat16")), device=dev,
                      df_table=build_df_table(df, float(n_img), dev))
        sc_batch = dict(batch, **scst_gts(labels, BENCH_BATCH))
        tcap, tnmt = build_transformer_models(dev)
        fc, att = make_features(np.random.RandomState(41), BENCH_BATCH)
        feats = Features(fc_feats=to_bfloat16(fc).to(dev),
                         att_feats=to_bfloat16(att).to(dev),
                         att_masks=torch.ones((BENCH_BATCH, N_SLOTS),
                                              device=dev))
        c2n = torch.as_tensor(_cap2nmt(), device=dev)

        def pivot():
            with torch.inference_mode():
                return pivot_translate(tcap, tnmt, feats, c2n,
                                       cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                                       nmt_max_len=NMT_MAX_LEN)

        for name, fn in (("transformer SCST step, bf16",
                          lambda: tsc.train(sc_batch, sc_flag=True)),
                         ("transformer pivot, rounded features", pivot)):
            fn()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            parts = {}
            ms, how = library_ms(fn, 1, parts)
            b4 = sum(v for n, v in parts.items()
                     if any(k in n for k in TF_TFD_KERNELS))
            readings.append(dict(kernel=name, shape=f"batch {BENCH_BATCH}",
                                 walls_ms=walls, ms=ms, timing=how,
                                 b4_ms=b4, parts=parts))
            log(f"time {name} [batch {BENCH_BATCH}]: walls "
                + ", ".join(f"{w:.1f}" for w in walls)
                + f" ms; device busy {ms:.2f} ms ({how}), of it B4's "
                f"kernels {b4:.2f} ms; by CUDA kernel: " + ", ".join(
                    f"{n} {v:.2f}" for n, v in sorted(
                        parts.items(), key=lambda kv: -kv[1])[:8]))
        del tsc, tcap, tnmt
        torch.cuda.empty_cache()
    if "img" in groups:
        from unpaired_image_captioning_tpu_torch.kernels import image as ik

        for label, b, h, w, out in IMG_CASES:
            _, x = _img_input(dev, b, h, w)
            rec("image_front_end", f"[{b}, {h}, {w}, 3] -> {out}x{out} "
                f"({label})", lambda: ik.resize_normalize(x, h_out=out,
                                                          w_out=out))
    return readings


def _first_refused_width(check, most: int = 1 << 16):
    """The least head width w <= most for which check(w) raises ValueError
    (refusal grows with the width), or None if it never does."""
    def refused(w):
        try:
            check(w)
        except ValueError:
            return True
        return False

    if not refused(most):
        return None
    lo, hi = 0, most               # refused(hi), not refused(lo)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if refused(mid):
            hi = mid
        else:
            lo = mid
    return hi


def build_models(dev):
    """Full-width denseatt captioner and BiLSTM NMT with random weights from
    seed 0, plus synthetic vocabularies and the caption->NMT id map."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.att import DenseAttModel
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    cap = DenseAttModel(**CAP, device=dev).init_params(
        torch.Generator().manual_seed(0))
    nmt = NMTModel(**NMT, device=dev).init_params(
        torch.Generator().manual_seed(0))
    cap.eval()
    nmt.eval()
    v = CAP["vocab_size"]
    zh_vocab = {str(i): f"zh{i}" for i in range(1, v + 1)}
    tgt_itos = {i: f"en{i}" for i in range(NMT["tgt_vocab_size"])}
    return cap, nmt, zh_vocab, tgt_itos, _cap2nmt()


def _cap2nmt() -> np.ndarray:
    """The caption id -> NMT source id map: PAD for 0, UNK (1) for every
    50th word."""
    v, src_v = CAP["vocab_size"], NMT["src_vocab_size"]
    cap2nmt = np.zeros((v + 1,), np.int64)
    ids = np.arange(1, v + 1)
    cap2nmt[1:] = np.where(ids % 50 == 0, 1, 4 + (ids - 1) % (src_v - 4))
    return cap2nmt


def make_features(rs, n: int):
    fc = rs.randn(n, CAP["fc_feat_size"]).astype(np.float32)
    att = rs.randn(n, N_SLOTS, CAP["att_feat_size"]).astype(np.float32)
    return fc, att


def phase_slice(dev, cap, nmt, zh_vocab, tgt_itos, cap2nmt, counters: dict,
                label: str) -> dict:
    """Serve the pivot task at full width through PivotService and HTTP;
    returns the kernels' launch counts during the run. `counters` maps a
    kernel's name to (module, attribute) of its launch count; each is set
    to 0 just before the requests and read just after them."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.pivot import pivot_translate
    from unpaired_image_captioning_tpu_torch.serve import (CaptionService,
                                                           PivotService,
                                                           make_http_server)

    rs = np.random.RandomState(0)
    fc, att = make_features(rs, N_REQUESTS)
    cap2nmt_t = torch.as_tensor(cap2nmt, device=dev)

    def feats(f, a):
        return Features(fc_feats=torch.as_tensor(f, device=dev),
                        att_feats=torch.as_tensor(a, device=dev),
                        att_masks=torch.ones(a.shape[:2], device=dev))

    # first CUDA use of every op on the path (library handles, allocator)
    pivot_translate(cap, nmt, feats(fc[:2], att[:2]), cap2nmt_t,
                    cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                    nmt_max_len=NMT_MAX_LEN)
    torch.cuda.synchronize()

    svc = PivotService(cap, nmt, zh_vocab, tgt_itos, cap2nmt,
                       cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                       nmt_max_len=NMT_MAX_LEN, max_batch=MAX_BATCH)
    cap_svc = CaptionService(cap, zh_vocab, beam_size=CAP_BEAM,
                             max_batch=MAX_BATCH)
    server = make_http_server(cap_svc, port=0, pivot_service=svc)
    port = server.server_address[1]
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    try:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        answers = [None] * N_REQUESTS
        latency = [None] * N_REQUESTS

        def one(i):
            t0 = time.perf_counter()
            answers[i] = svc.pivot(fc[i], att[i], timeout=600)
            latency[i] = time.perf_counter() - t0

        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(N_REQUESTS)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(600)
        wall = time.perf_counter() - t0
        if any(w.is_alive() for w in workers) or None in answers:
            raise AssertionError("not every concurrent request was answered")
        batches = svc.batcher.stats["batches"]
        if batches < 2:
            raise AssertionError(f"{N_REQUESTS} requests formed {batches} "
                                 "micro-batch; expected more than one")

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/pivot",
            data=json.dumps({"fc": fc[0].tolist(),
                             "att": att[0].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_answer = json.loads(r.read())
        direct = svc.pivot(fc[0], att[0], timeout=600)   # same batch shape
        torch.cuda.synchronize()
        counts = {name: getattr(mod, attr)
                  for name, (mod, attr) in counters.items()}
    finally:
        server.shutdown()
        server.server_close()
        server_thread.join(10)
        svc.close()
        cap_svc.close()

    for i, a in enumerate(answers + [http_answer]):
        if not (isinstance(a, dict) and a.get("zh") and a.get("en")):
            raise AssertionError(f"answer {i} lacks a zh or en caption: {a}")
    if http_answer != direct:
        raise AssertionError(f"HTTP answer {http_answer} != direct {direct}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"the {label} path never launched kernel "
                                 f"{name}")
    lat_ms = sorted(x * 1e3 for x in latency)
    log(f"{label}: {N_REQUESTS} concurrent requests in {batches} "
        f"micro-batches ({wall:.2f} s wall), latency p50 "
        f"{statistics.median(lat_ms):.1f} ms, max {lat_ms[-1]:.1f} ms; HTTP "
        "/pivot == direct; launches " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
    log(f"{label}: sample answer "
        f"{json.dumps(answers[0], ensure_ascii=False)}")

    # throughput of one batch-50 pivot_translate (after one warm-up call)
    bfc, batt = make_features(rs, BENCH_BATCH)
    bf = feats(bfc, batt)
    zh, en, aux = pivot_translate(cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM,
                                  nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
    torch.cuda.synchronize()
    before = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    t0 = time.perf_counter()
    zh, en, aux = pivot_translate(cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM,
                                  nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"{label}: launches in one batch-{BENCH_BATCH} pivot_translate: "
        + ", ".join(f"{name} {getattr(mod, attr) - before[name]}"
                    for name, (mod, attr) in counters.items()))
    want = {"zh": (BENCH_BATCH, CAP["seq_length"]),
            "en": (BENCH_BATCH, NMT_MAX_LEN), "aux": (BENCH_BATCH, NMT_MAX_LEN)}
    for name, t in (("zh", zh), ("en", en), ("aux", aux)):
        if tuple(t.shape) != want[name]:
            raise AssertionError(f"pivot {name} shape {tuple(t.shape)}")
    if not (int(zh.min()) >= 0 and int(zh.max()) <= CAP["vocab_size"]
            and int(en.min()) >= 0 and int(en.max()) < NMT["tgt_vocab_size"]
            and int(aux.min()) >= 0 and int(aux.max()) < CAP["seq_length"]):
        raise AssertionError("pivot ids out of range")
    busy, per_name = device_ms(lambda: pivot_translate(
        cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
        nmt_max_len=NMT_MAX_LEN))
    busy_msg = ("device busy not measured (the profiler recorded no device "
                "time)" if busy is None else
                f"device busy {busy:.1f} ms (kernel time), idle share "
                f"{1 - busy / (secs * 1e3):.2f}")
    log(f"{label}: batch-{BENCH_BATCH} pivot_translate {secs * 1e3:.1f} ms, "
        f"{BENCH_BATCH / secs:.1f} images/s; {busy_msg}")
    per_name = per_name or {}
    hand_us = sum(us for n, (us, _) in per_name.items()
                  if any(k in n for k in HAND_KERNELS))
    if busy is not None:
        log(f"{label}: of the device busy time, {hand_us / 1e3:.1f} ms in the "
            f"kernels of csrc/ ({hand_us / 1e3 / busy:.2f}); "
            + _kernel_share(per_name, "topk_select_kernel"))
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in top[:TOP_OPS]:
        log(f"{label}: device op {us / 1e3:8.3f} ms {n:6d}x  {name[:90]}")
    return counts


def _kernel_share(per_name: dict, kernel: str) -> str:
    """`kernel`'s device time and launches in a profiled run."""
    hits = [(us, n) for name, (us, n) in (per_name or {}).items()
            if kernel in name]
    return (f"{kernel} {sum(us for us, _ in hits) / 1e3:.3f} ms in "
            f"{sum(n for _, n in hits)} launches")


def _nmt_teacher_forced(nmt, src, lengths, tgt):
    """NMT logprobs [B, T-1, V] along the target tokens tgt [B, T] (BOS
    first), through `NMTModel.forward`; and the encoder context."""
    import torch

    outs, _ = nmt.forward(src, lengths, tgt)
    return (nmt.encoder.apply(src, lengths)[0],
            torch.log_softmax(nmt.generator_logits(outs), -1))


def phase_agreement(dev, cap, nmt, cap2nmt) -> None:
    """The same four images through the models on the card (kernels) and
    on the CPU (plain versions). Hard check: teacher-forced logprobs of the
    captioner and the NMT, and the NMT encoder context, agree within
    AGREE_TOL. Informational: zh/en token agreement of the beams, and at
    the first differing step the per-token logprob gap (a near-tie shows
    as a small gap)."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.pivot import (
        captions_to_nmt_batch)

    n = 4
    fc, att = make_features(np.random.RandomState(1), n)
    cpu = torch.device("cpu")
    cap_c = copy.deepcopy(cap).to(cpu)
    nmt_c = copy.deepcopy(nmt).to(cpu)
    res = {}
    with torch.inference_mode():
        for name, d, cm, nm in (("gpu", dev, cap, nmt),
                                ("cpu", cpu, cap_c, nmt_c)):
            f = Features(fc_feats=torch.as_tensor(fc, device=d),
                         att_feats=torch.as_tensor(att, device=d),
                         att_masks=torch.ones((n, N_SLOTS), device=d))
            cb = cm.sample_beam(f, beam_size=CAP_BEAM)
            res[name] = dict(feats=f, cap=cb)
        # the NMT on the CPU's zh, so that both sides translate one source
        zh = res["cpu"]["cap"].seq[:, 0]
        for name, d, nm in (("gpu", dev, nmt), ("cpu", cpu, nmt_c)):
            src, lengths = captions_to_nmt_batch(
                zh.to(d), torch.as_tensor(cap2nmt, device=d))
            res[name]["nmt"] = nm.translate_batch(
                src, lengths, beam_size=NMT_BEAM, max_len=NMT_MAX_LEN)
            res[name]["src"] = (src, lengths)
        # hard checks: the same tokens through both devices
        seq = torch.cat([torch.zeros((n, 1), dtype=torch.long), zh], 1)
        lp_g = cap.forward(res["gpu"]["feats"], seq.to(dev)).cpu()
        lp_c = cap_c.forward(res["cpu"]["feats"], seq)
        en = res["cpu"]["nmt"].seq[:, 0]
        tgt = torch.cat([torch.full((n, 1), NMT_BOS, dtype=torch.long),
                         en], 1)
        ctx_g, nlp_g = _nmt_teacher_forced(nmt, *res["gpu"]["src"], tgt.to(dev))
        ctx_c, nlp_c = _nmt_teacher_forced(nmt_c, *res["cpu"]["src"], tgt)
    errs = {"captioner logprobs": (lp_g - lp_c).abs().max().item(),
            "nmt encoder context": (ctx_g.cpu() - ctx_c).abs().max().item(),
            "nmt logprobs": (nlp_g.cpu() - nlp_c).abs().max().item()}
    log("agreement: card vs cpu, teacher-forced max|diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {AGREE_TOL})")
    bad = {k: v for k, v in errs.items() if not v <= AGREE_TOL}
    if bad:
        raise AssertionError(f"card and cpu disagree: {bad}")
    _token_agreement(res, "agreement")


def _token_agreement(res: dict, label: str) -> None:
    """Informational: zh/en top-beam token agreement of card and CPU, and
    at the first differing step the per-token logprob gap (a near-tie shows
    as a small gap)."""
    for part in ("cap", "nmt"):
        g, c = res["gpu"][part], res["cpu"][part]
        gs, cs = g.seq[:, 0].cpu(), c.seq[:, 0]
        same = (gs == cs).float().mean().item()
        msg = (f"{label}: {'zh' if part == 'cap' else 'en'} top-beam tokens "
               f"{same * 100:.1f}% equal")
        diff = (gs != cs).nonzero()
        if len(diff):
            b, t = (int(v) for v in diff[0])
            gap = (g.logps[b, 0, t].item() - c.logps[b, 0, t].item())
            msg += (f"; first difference image {b} step {t}: token "
                    f"{int(gs[b, t])} vs {int(cs[b, t])}, per-token logprob "
                    f"gap {gap:.3g}, score gap "
                    f"{g.scores[b, 0].item() - c.scores[b, 0].item():.3g}")
        log(msg)


def _count_calls(obj, name: str, counter: dict, key: str):
    """Shadow obj.name with a wrapper that counts its calls in
    counter[key]; `del obj.<name>` restores the method."""
    fn = getattr(obj, name)

    def counted(*a, **kw):
        counter[key] += 1
        return fn(*a, **kw)

    setattr(obj, name, counted)


def phase_wide_beams(dev, cap, nmt, cap2nmt) -> int:
    """The LSTM pivot at caption beam 20 -> NMT beam 32, batch 50, full
    width: every beam step's row top-k goes through the chunked kernel
    (`ops/topk.py::topk_route`), so its launches must equal the decode
    steps the two beams ran, with no row_topk launch and no sort; images/s
    and device busy; four images token-identical to the CPU port; one NMT
    translate at beam 40, past the chunked domain, through the counted
    sort; the same four images at caption beam 20 with BEAMS_KERNEL (the
    K-beam attention kernel at K = 20, two beams wider than a block's group
    of 16). Returns the chunked kernel's launches in the batch-50 run."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.ops import topk as ot
    from unpaired_image_captioning_tpu_torch.pivot import (
        captions_to_nmt_batch, pivot_translate)

    v_cap, v_nmt = CAP["vocab_size"] + 1, NMT["tgt_vocab_size"]
    routes = (ot.topk_route(WIDE_CAP_BEAM, v_cap),
              ot.topk_route(WIDE_NMT_BEAM, v_nmt),
              ot.topk_route(SORT_NMT_BEAM, v_nmt))
    if routes != ("chunked_topk", "chunked_topk", "sort"):
        raise AssertionError(f"wide-beam routes {routes}")

    def feats(fc, att, d):
        return Features(fc_feats=torch.as_tensor(fc, device=d),
                        att_feats=torch.as_tensor(att, device=d),
                        att_masks=torch.ones(att.shape[:2], device=d))

    f = feats(*make_features(np.random.RandomState(9), BENCH_BATCH), dev)
    c2n = torch.as_tensor(cap2nmt, device=dev)

    def pivot():
        return pivot_translate(cap, nmt, f, c2n, cap_beam=WIDE_CAP_BEAM,
                               nmt_beam=WIDE_NMT_BEAM,
                               nmt_max_len=NMT_MAX_LEN)

    steps = {"cap": 0, "nmt": 0}
    with torch.inference_mode():
        pivot()                                           # warm-up
        torch.cuda.synchronize()
        _count_calls(cap, "step", steps, "cap")
        _count_calls(nmt.decoder, "step", steps, "nmt")
        try:
            ck.launches = tk.launches = ot.sort_calls = 0
            t0 = time.perf_counter()
            zh, en, aux = pivot()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = (ck.launches, tk.launches, ot.sort_calls)
        finally:
            del cap.step, nmt.decoder.step
    # one row top-k a decode step of each beam (`_flat_topk`), all chunked
    want = (steps["cap"] + steps["nmt"], 0, 0)
    if got != want:
        raise AssertionError(f"wide beams: (chunked_topk, row_topk, sort) "
                             f"launches {got}, expected {want} for "
                             f"{steps} decode steps")
    if not (tuple(zh.shape) == (BENCH_BATCH, CAP["seq_length"])
            and tuple(en.shape) == (BENCH_BATCH, NMT_MAX_LEN)
            and int(zh.min()) >= 0 and int(zh.max()) <= CAP["vocab_size"]
            and int(en.min()) >= 0 and int(en.max()) < v_nmt
            and int(aux.min()) >= 0 and int(aux.max()) < CAP["seq_length"]):
        raise AssertionError("wide-beam pivot output out of shape or range")
    busy, per_name = device_ms(pivot)
    busy_msg = ("device busy not measured" if busy is None else
                f"device busy {busy:.1f} ms, idle share "
                f"{1 - busy / (secs * 1e3):.2f}, "
                + _kernel_share(per_name, "topk_select_kernel"))
    log(f"wide beams: batch-{BENCH_BATCH} pivot_translate at caption beam "
        f"{WIDE_CAP_BEAM} -> NMT beam {WIDE_NMT_BEAM}: {secs * 1e3:.1f} ms, "
        f"{BENCH_BATCH / secs:.1f} images/s; {busy_msg}; {steps['cap']} "
        f"caption + {steps['nmt']} NMT decode steps, chunked_topk launches "
        f"{got[0]} (row_topk {got[1]}, sort {got[2]})")

    # four images against the CPU: the captions, then both NMTs on the
    # CPU's captions
    n = 4
    fc4, att4 = make_features(np.random.RandomState(10), n)
    cpu = torch.device("cpu")
    cap_c, nmt_c = copy.deepcopy(cap).to(cpu), copy.deepcopy(nmt).to(cpu)
    with torch.inference_mode():
        rg = cap.sample_beam(feats(fc4, att4, dev), beam_size=WIDE_CAP_BEAM)
        rc = cap_c.sample_beam(feats(fc4, att4, cpu), beam_size=WIDE_CAP_BEAM)
        trans = {}
        for name, d, nm in (("gpu", dev, nmt), ("cpu", cpu, nmt_c)):
            src, lengths = captions_to_nmt_batch(
                rc.seq[:, 0].to(d), torch.as_tensor(cap2nmt, device=d))
            trans[name] = nm.translate_batch(src, lengths,
                                             beam_size=WIDE_NMT_BEAM,
                                             max_len=NMT_MAX_LEN)
    same_zh = torch.equal(rg.seq[:, 0].cpu(), rc.seq[:, 0])
    same_en = torch.equal(trans["gpu"].seq[:, 0].cpu(),
                          trans["cpu"].seq[:, 0])
    gap = max((rg.scores.cpu() - rc.scores).abs().max().item(),
              (trans["gpu"].scores.cpu() - trans["cpu"].scores).abs().max()
              .item())
    log(f"wide beams: {n} images card vs cpu, zh top-beam tokens "
        f"{'identical' if same_zh else 'DIFFER'}, en top-beam tokens "
        f"{'identical' if same_en else 'DIFFER'}; beam scores max|diff| "
        f"{gap:.3g} (tol {AGREE_TOL})")
    if not (same_zh and same_en and gap <= AGREE_TOL):
        raise AssertionError("wide beams: card and cpu disagree")
    del cap_c, nmt_c

    # the K-beam attention kernel at K = 20 against the CPU's default route
    old = _att_flags(BEAMS_KERNEL=True)
    calls = {"cap": 0}
    try:
        with torch.inference_mode():
            aak.beams_launches = 0
            _count_calls(cap, "step", calls, "cap")
            try:
                rk = cap.sample_beam(feats(fc4, att4, dev),
                                     beam_size=WIDE_CAP_BEAM)
                torch.cuda.synchronize()
            finally:
                del cap.step
    finally:
        _att_flags(**old)
    same_k = torch.equal(rk.seq[:, 0].cpu(), rc.seq[:, 0])
    gap_k = (rk.scores.cpu() - rc.scores).abs().max().item()
    log(f"wide beams: BEAMS_KERNEL caption beam {WIDE_CAP_BEAM}, {n} images "
        f"card vs cpu: zh top-beam tokens "
        f"{'identical' if same_k else 'DIFFER'}, beam scores max|diff| "
        f"{gap_k:.3g} (tol {AGREE_TOL}); additive_attention_beams launches "
        f"{aak.beams_launches} in {calls['cap']} caption steps")
    if aak.beams_launches != 2 * calls["cap"] or calls["cap"] == 0:
        raise AssertionError(f"BEAMS_KERNEL beam {WIDE_CAP_BEAM}: "
                             f"{aak.beams_launches} launches in "
                             f"{calls['cap']} caption steps")
    if not (same_k and gap_k <= AGREE_TOL):
        raise AssertionError(f"BEAMS_KERNEL beam {WIDE_CAP_BEAM}: card and "
                             "cpu disagree")

    # NMT beam 40: rows of 8571 are narrower than 2 * 40 * 128, so the
    # stable sort, as the JAX package's lax.top_k there
    src, lengths = captions_to_nmt_batch(zh, c2n)
    steps["nmt"] = 0
    with torch.inference_mode():
        _count_calls(nmt.decoder, "step", steps, "nmt")
        try:
            before = ck.launches
            ot.sort_calls = 0
            res = nmt.translate_batch(src, lengths, beam_size=SORT_NMT_BEAM,
                                      max_len=NMT_MAX_LEN)
            torch.cuda.synchronize()
        finally:
            del nmt.decoder.step
    if not (ot.sort_calls == steps["nmt"] > 0 and ck.launches == before
            and tuple(res.seq.shape) == (BENCH_BATCH, SORT_NMT_BEAM,
                                         NMT_MAX_LEN)):
        raise AssertionError(f"NMT beam {SORT_NMT_BEAM}: sort_calls "
                             f"{ot.sort_calls} in {steps['nmt']} steps, "
                             f"chunked_topk {ck.launches - before}")
    log(f"wide beams: NMT translate at beam {SORT_NMT_BEAM}, batch "
        f"{BENCH_BATCH}: {steps['nmt']} steps, sort_calls {ot.sort_calls}, "
        "chunked_topk launches unchanged")
    return got[0]


def phase_wide_transformer_nmt(dev, nmt) -> None:
    """The transformer NMT's translate_batch at beam 32, batch 50: 1,600
    rows through the decoder-step kernel and the chunked top-k every
    step."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    rs = np.random.RandomState(11)
    lengths = rs.randint(6, NMT_SRC_LEN + 1, BENCH_BATCH)
    src = rs.randint(4, TNMT["src_vocab_size"], (BENCH_BATCH, NMT_SRC_LEN))
    src[np.arange(NMT_SRC_LEN)[None, :] >= lengths[:, None]] = 0
    steps = {"nmt": 0}
    with torch.inference_mode():
        _count_calls(nmt, "step", steps, "nmt")
        try:
            ck.launches = tdk.stack_launches = 0
            t0 = time.perf_counter()
            res = nmt.translate_batch(
                torch.as_tensor(src, device=dev),
                torch.as_tensor(lengths, device=dev),
                beam_size=WIDE_NMT_BEAM, max_len=NMT_MAX_LEN)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            del nmt.step
    got = (ck.launches, tdk.stack_launches)
    if got != (steps["nmt"], steps["nmt"]) or steps["nmt"] <= 0:
        raise AssertionError(f"transformer NMT beam {WIDE_NMT_BEAM}: "
                             f"(chunked_topk, stack) launches {got} in "
                             f"{steps['nmt']} steps")
    seq = res.seq
    if not (tuple(seq.shape) == (BENCH_BATCH, WIDE_NMT_BEAM, NMT_MAX_LEN)
            and int(seq.min()) >= 0
            and int(seq.max()) < TNMT["tgt_vocab_size"]
            and bool(torch.isfinite(res.scores).all())):
        raise AssertionError("transformer NMT wide beam: bad output")
    log(f"wide beams: transformer NMT translate_batch at beam "
        f"{WIDE_NMT_BEAM}, batch {BENCH_BATCH} ({BENCH_BATCH * WIDE_NMT_BEAM} "
        f"rows): {secs * 1e3:.1f} ms, {steps['nmt']} steps; chunked_topk and "
        f"decoder_stack_step launches {got[0]} each")


# ---------------------------------------------------------------------------
# the transformer pivot
# ---------------------------------------------------------------------------

def _tfd_inputs(dev, gen, b, kb, n_l, n_t, slots, d, dff, lazy: bool):
    """Decoder-step inputs at one path shape: weights at the models' init
    scales, caches holding earlier positions, a ragged src_mask; per-row t
    with staggered rows, or (lazy) one t for all rows with `anc` drawn as
    the ancestry of a random beam history."""
    import torch

    from unpaired_image_captioning_tpu_torch.ops.transformer_decode import (
        WKEYS)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = b * kb
    mats = {"wqkv": (d, 3 * d), "wo_s": (d, d), "wq_c": (d, d),
            "wo_c": (d, d), "w1": (d, dff), "w2": (dff, d)}
    vecs = {"bqkv": 3 * d, "b1": dff}
    w = {}
    for k in WKEYS:
        if k in mats:
            fan_in = mats[k][0]
            w[k] = ((torch.rand((n_l,) + mats[k], generator=gen, device=dev)
                     * 2 - 1) / fan_in ** 0.5)
        elif k.startswith("ln") and k.endswith("_s"):
            w[k] = 1 + 0.1 * rnd(n_l, d)
        else:
            w[k] = 0.1 * rnd(n_l, vecs.get(k, d))
    lengths = torch.randint(1, slots + 1, (b,), generator=gen, device=dev)
    lengths[0] = slots
    mask = (torch.arange(slots, device=dev)[None, :]
            < lengths[:, None]).float()
    local = torch.arange(rows, device=dev) % kb
    if lazy:
        t_now = n_t - 3
        t = torch.full((rows,), t_now, dtype=torch.int32, device=dev)
        anc = local[:, None].expand(rows, n_t).clone()
        base = (torch.arange(b, device=dev) * kb)[:, None]
        pos = torch.arange(n_t, device=dev)[None, :]
        for step in range(t_now):
            parent = torch.randint(0, kb, (b, kb), generator=gen, device=dev)
            re = anc[(base + parent).reshape(-1)]
            anc = torch.where(pos <= step, re, local[:, None])
        anc = anc.to(torch.int32).contiguous()
    else:
        t = torch.randint(0, n_t, (rows,), generator=gen, device=dev,
                          dtype=torch.int32)
        t[:3] = torch.tensor([0, n_t - 1, n_t // 2], dtype=torch.int32)
        anc = None
    return dict(w=w, x=rnd(rows, d), t=t, ck=rnd(n_l, b, slots, d),
                cv=rnd(n_l, b, slots, d), mask=mask,
                kc=0.5 * rnd(rows, n_l, n_t, d),
                vc=0.5 * rnd(rows, n_l, n_t, d), anc=anc)


def _tfd_bound(a, kb: int, layers: int, d: int, dff: int, weights,
               lazy: bool):
    """Bound of `layers` decoder-step layers on the inputs `a`: the weights,
    x in and out, each row's cache positions up to its t (read) and slot t
    (written), the cross K/V; five d-wide GEMMs and the FFN per row, and
    the attentions over the positions and unmasked slots this data needs."""
    rows = a["x"].shape[0]
    b, slots = a["mask"].shape
    pos = int((a["t"].long() + 1).sum())
    cross = int(a["mask"].sum(1).repeat_interleave(kb).sum())
    by = nbytes(*weights) + 2 * nbytes(a["x"]) + nbytes(a["t"], a["mask"])
    by += layers * 4 * (2 * pos * d + 2 * rows * d + 2 * b * slots * d)
    if lazy:
        by += nbytes(a["anc"]) + rows * slots * 4   # anc in, attention out
    flops = layers * (2.0 * rows * (6 * d * d + 2 * d * dff)
                      + 4.0 * d * pos + 4.0 * d * cross)
    return bound(by, flops)


def _rel_err(outs_k, outs_p) -> float:
    """max|diff| over the outputs, over max(1, max|plain|)."""
    diff = max((a - b).abs().max().item() for a, b in zip(outs_k, outs_p))
    scale = max([1.0] + [b.abs().max().item() for b in outs_p])
    return diff / scale


def _tfd_rerun_check(a, heads: int, label: str) -> None:
    """The stack step with want_attn twice on copies of the same caches:
    x', both caches and the mean-head weights must be the same bits."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    outs = []
    for _ in range(2):
        outs.append(tdk.decoder_stack_step(
            a["x"], a["t"], a["ck"], a["cv"], a["mask"], a["kc"].clone(),
            a["vc"].clone(), a["w"], a["anc"], n_heads=heads,
            want_attn=True))
    torch.cuda.synchronize()
    same = [torch.equal(p, q) for p, q in zip(*outs)]
    if not all(same):
        raise AssertionError(f"transformer_decode_stack ({label}): a rerun "
                             "with want_attn changed (x', cache_k, cache_v, "
                             f"attn) equal = {same}")
    log(f"kernel transformer_decode_stack ({label}): x', caches and the "
        "want_attn weights bit-identical on a rerun")


def _tfd_cublas_gemms(w, rows: int, d: int, dff: int, dev):
    """Device time of the 6 products a layer at their shapes through
    torch.matmul (cuBLAS, TF32 off), over the layers of `w` (each key
    [L, ...]), on activations of the step's size: (ms, how it was read).
    A yardstick of the GEMMs, not a library counterpart of the step."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    act = torch.randn((rows, max(d, dff)), generator=gen, device=dev)
    y, h1 = act[:, :d].contiguous(), act[:, :dff].contiguous()
    n_l = w["wqkv"].shape[0]

    def run():
        for l in range(n_l):
            torch.matmul(y, w["wqkv"][l])
            torch.matmul(y, w["wo_s"][l])
            torch.matmul(y, w["wq_c"][l])
            torch.matmul(y, w["wo_c"][l])
            torch.matmul(y, w["w1"][l])
            torch.matmul(h1, w["w2"][l])

    return library_ms(run)


def phase_tfd_kernels(dev) -> dict:
    """The decoder-step kernel against its plain version at both path
    shapes, as the 6-layer stack and as one layer; returns the kernels'
    records for the JSON line."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops import (
        transformer_decode as td)

    gen = torch.Generator(device=dev).manual_seed(1)
    src = "unpaired_image_captioning_tpu_torch/csrc/transformer_decode.cu"
    recs = {"transformer_decode_stack": [], "transformer_decode_layer": []}
    for label, b, kb, n_l, n_t, slots, d, dff, heads, lazy in TFD_SHAPES:
        a = _tfd_inputs(dev, gen, b, kb, n_l, n_t, slots, d, dff, lazy)
        rows = b * kb
        shape = (f"R={rows} kb={kb} L={n_l} T={n_t} S={slots} d={d} "
                 f"ff={dff} H={heads}")
        kk, vk, kp, vp = (c.clone() for c in (a["kc"], a["vc"], a["kc"],
                                              a["vc"]))

        def stack_k():
            return tdk.decoder_stack_step(
                a["x"], a["t"], a["ck"], a["cv"], a["mask"], kk, vk, a["w"],
                a["anc"], n_heads=heads, want_attn=lazy)

        def stack_p():
            return td.decoder_stack_step_plain(
                a["x"], a["t"], a["ck"], a["cv"], a["mask"], kp, vp, a["w"],
                a["anc"], n_heads=heads, want_attn=lazy)

        err = _rel_err(stack_k(), stack_p())
        torch.cuda.synchronize()
        _tfd_rerun_check(a, heads, label)
        w0 = {k: v[0].contiguous() for k, v in a["w"].items()}
        # the yardstick of each record over its own weights: one layer's
        # stay in L2 across a timed loop, a 6-layer stack's do not
        gemms = {"transformer_decode_stack":
                 _tfd_cublas_gemms(a["w"], rows, d, dff, dev),
                 "transformer_decode_layer":
                 _tfd_cublas_gemms({k: v[None] for k, v in w0.items()},
                                   rows, d, dff, dev)}
        ck0, cv0 = a["ck"][0].contiguous(), a["cv"][0].contiguous()
        lk_, lv_, lkp, lvp = (c[:, 0].contiguous() for c in (
            a["kc"], a["vc"], a["kc"], a["vc"]))

        def layer_k():
            return tdk.decoder_layer_step(a["x"], a["t"], ck0, cv0, a["mask"],
                                          lk_, lv_, w0, n_heads=heads)

        def layer_p():
            return td.decoder_layer_step_plain(a["x"], a["t"], ck0, cv0,
                                               a["mask"], lkp, lvp, w0,
                                               n_heads=heads)

        err_l = _rel_err(layer_k(), layer_p())
        torch.cuda.synchronize()
        for name, e, kfn, pfn, what, (b_ms, b_by) in (
                ("transformer_decode_stack", err, stack_k, stack_p,
                 f"{n_l}-layer stack" + (", lazy anc, want_attn" if lazy
                                         else ", per-row t"),
                 _tfd_bound(a, kb, n_l, d, dff, list(a["w"].values()),
                            lazy)),
                ("transformer_decode_layer", err_l, layer_k, layer_p,
                 "one layer, per-row t",
                 _tfd_bound(a, kb, 1, d, dff, list(w0.values()), False))):
            if not e <= TFD_TOL:
                raise AssertionError(f"{name} {label}: max|diff| / max(1, "
                                     f"max|plain|) = {e} > {TFD_TOL}")
            parts = {}
            k_ms, p_ms, k_wall, p_wall, how = time_pair(kfn, pfn, TFD_KERNELS,
                                                        parts=parts)
            mine_gemm = sum(ms for n, (ms, _) in parts.items()
                            if "decode_gemm_kernel" in n)
            layers = n_l if name.endswith("stack") else 1
            gemm_ms, gemm_how = gemms[name]
            recs[name].append(dict(shape=f"{label}: {shape}", err=e, ms=k_ms,
                                   plain_ms=p_ms, wall_ms=k_wall,
                                   plain_wall_ms=p_wall, bound_ms=b_ms,
                                   bound_by=b_by, timing=how,
                                   gemms_ms=mine_gemm,
                                   gemms_cublas_ms=gemm_ms))
            log(f"kernel {name} [{shape}] ({label}, {what}): max|diff| / "
                f"max(1, max|plain|) {e:.3g} (tol {TFD_TOL}); {how}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per call kernel "
                f"{k_wall:.4f} ms, plain {p_wall:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}); library: no single PyTorch call")
            if parts:
                log(f"  {name} ({label}) by CUDA kernel, per call: "
                    + ", ".join(f"{n} {ms:.4f} ms x{c:g}" for n, (ms, c) in
                                sorted(parts.items(),
                                       key=lambda kv: -kv[1][0])))
            log(f"  {name} ({label}): its {6 * layers} GEMMs "
                f"{mine_gemm:.4f} ms in decode_gemm_kernel; the same "
                f"products through torch.matmul (cuBLAS, TF32 off) "
                f"{gemm_ms:.4f} ms ({gemm_how}), a yardstick "
                "of the GEMMs alone, not of the step")
    replaces = {"transformer_decode_stack":
                "unpaired_image_captioning_tpu/ops/transformer_decode.py:275",
                "transformer_decode_layer":
                "unpaired_image_captioning_tpu/ops/transformer_decode.py:229"}
    out = {}
    for name, rs in recs.items():
        # the record's numbers: the stack at the NMT's beam, the layer at
        # the caption's; every shape is in "shapes"
        main = rs[1] if name.endswith("stack") else rs[0]
        out[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name],
            "max_abs_err": max(r["err"] for r in rs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": main["shape"], "timing": main["timing"],
            "err_is": "max|diff| / max(1, max|plain|)", "shapes": rs}
    return out


def build_transformer_models(dev):
    """Full-width transformer captioner and transformer NMT with random
    weights from seed 0, plus the vocabularies and the id map of
    `build_models`."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
        TransformerNMTModel)
    from unpaired_image_captioning_tpu_torch.models.transformer import (
        TransformerModel)

    cap = TransformerModel(**TCAP, device=dev).init_params(
        torch.Generator().manual_seed(0))
    nmt = TransformerNMTModel(**TNMT, device=dev).init_params(
        torch.Generator().manual_seed(0))
    cap.eval()
    nmt.eval()
    return cap, nmt


def phase_layer_route(dev, cap) -> int:
    """Decode four images with the captioner's per-layer route
    (`STACK_KERNEL = False`, one decoder_layer_step call per layer) and
    require the stack route's tokens; returns the per-layer launches."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models import transformer as tm
    from unpaired_image_captioning_tpu_torch.models.base import Features

    n = 4
    fc, att = make_features(np.random.RandomState(2), n)
    f = Features(fc_feats=torch.as_tensor(fc, device=dev),
                 att_feats=torch.as_tensor(att, device=dev),
                 att_masks=torch.ones((n, N_SLOTS), device=dev))
    with torch.inference_mode():
        stack = cap.sample_beam(f, beam_size=CAP_BEAM)
        tm.STACK_KERNEL = False
        try:
            tdk.layer_launches = 0
            layer = cap.sample_beam(f, beam_size=CAP_BEAM)
            torch.cuda.synchronize()
            launches = tdk.layer_launches
        finally:
            tm.STACK_KERNEL = True
    if launches <= 0:
        raise AssertionError("the per-layer route never launched "
                             "transformer_decode_layer")
    if not torch.equal(layer.seq, stack.seq):
        raise AssertionError("per-layer route tokens differ from the stack "
                             "route's")
    gap = (layer.scores - stack.scores).abs().max().item()
    log(f"transformer per-layer route: {n} images at beam {CAP_BEAM}, "
        f"tokens equal to the stack route's, max score gap {gap:.3g}; "
        f"launches transformer_decode_layer {launches}")
    return launches


def _incremental_logprobs(step, ctx, state, first, tokens):
    """Teacher-forced logprobs [B, T, V] through the model's incremental
    `step`: feed `first`, then tokens[:, :-1]."""
    import torch

    out = []
    it = first
    for i in range(tokens.shape[1]):
        lp, state = step(ctx, state, it)
        out.append(lp)
        it = tokens[:, i]
    return torch.stack(out, 1)


def phase_agreement_transformer(dev, cap, nmt, cap2nmt) -> None:
    """The same four images through the transformer models on the card
    (decoder-step kernel) and on the CPU (plain version). Hard check: the
    teacher-forced logprobs of both models through their incremental
    `step` agree within AGREE_TOL (the parallel `forward` would bypass the
    kernel). Informational: top-beam token agreement."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.pivot import (
        captions_to_nmt_batch)

    n = 4
    fc, att = make_features(np.random.RandomState(1), n)
    cpu = torch.device("cpu")
    cap_c = copy.deepcopy(cap).to(cpu)
    nmt_c = copy.deepcopy(nmt).to(cpu)
    res = {}
    with torch.inference_mode():
        for name, d, cm in (("gpu", dev, cap), ("cpu", cpu, cap_c)):
            masks = torch.ones((n, N_SLOTS), device=d)
            masks[1, 150:] = 0.0                         # padded slots
            f = Features(fc_feats=torch.as_tensor(fc, device=d),
                         att_feats=torch.as_tensor(att, device=d),
                         att_masks=masks)
            res[name] = dict(feats=f, cap=cm.sample_beam(f,
                                                         beam_size=CAP_BEAM))
        zh = res["cpu"]["cap"].seq[:, 0]
        for name, d, nm in (("gpu", dev, nmt), ("cpu", cpu, nmt_c)):
            src, lengths = captions_to_nmt_batch(
                zh.to(d), torch.as_tensor(cap2nmt, device=d))
            res[name]["nmt"] = nm.translate_batch(
                src, lengths, beam_size=NMT_BEAM, max_len=NMT_MAX_LEN)
            res[name]["src"] = (src, lengths)
        en = res["cpu"]["nmt"].seq[:, 0]
        lps = {}
        for name, d, cm, nm in (("gpu", dev, cap, nmt),
                                ("cpu", cpu, cap_c, nmt_c)):
            ctx, st = cm.make_decoder(res[name]["feats"])
            bos = torch.zeros((n,), dtype=torch.long, device=d)
            lp_cap = _incremental_logprobs(cm.step, ctx, st, bos, zh.to(d))
            ctx, st = nm.make_decoder(*res[name]["src"], NMT_MAX_LEN)
            lp_nmt = _incremental_logprobs(nm.step, ctx, st, bos + NMT_BOS,
                                           en.to(d))
            lps[name] = (lp_cap.cpu(), lp_nmt.cpu())
    errs = {"captioner incremental logprobs":
            (lps["gpu"][0] - lps["cpu"][0]).abs().max().item(),
            "nmt incremental logprobs":
            (lps["gpu"][1] - lps["cpu"][1]).abs().max().item()}
    log("transformer agreement: card vs cpu, teacher-forced max|diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {AGREE_TOL})")
    bad = {k: v for k, v in errs.items() if not v <= AGREE_TOL}
    if bad:
        raise AssertionError(f"card and cpu disagree: {bad}")
    _token_agreement(res, "transformer agreement")


def phase_head_widths(dev) -> None:
    """A transformer captioner at each of HEAD_WIDTHS (head widths the
    kernels take since their widening; HW_LAYERS layers, d_ff = d, the
    other widths full): one XE step on two images on each of the three
    training routes, card vs CPU, with the route's kernels launched
    (`phase_train_agreement`); then a beam-5 decode of four images on the
    card through the decoder-step kernel, whose teacher-forced incremental
    logprobs must agree with the CPU's within AGREE_TOL."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.models.transformer import (
        TransformerModel)

    n = 4
    fc, att = make_features(np.random.RandomState(3), n)
    cpu = torch.device("cpu")
    for label, d, heads, dff in HEAD_WIDTHS:
        widths = dict(input_encoding_size=d, rnn_size=dff, num_heads=heads,
                      num_layers=HW_LAYERS)
        for enc_layer, dec_layer in ((True, False), (False, False),
                                     (True, True)):
            phase_train_agreement(dev, enc_layer, dec_layer, widths,
                                  f"{label}: d {d} over {heads} heads, "
                                  f"d_ff {dff}, {HW_LAYERS} layers")
        cap = TransformerModel(**dict(TCAP, **widths), device=dev).init_params(
            torch.Generator().manual_seed(0))
        cap.eval()
        cap_c = copy.deepcopy(cap).to(cpu)
        runs = (("gpu", dev, cap), ("cpu", cpu, cap_c))
        feats, seqs, lps = {}, {}, {}
        with torch.inference_mode():
            for name, where, cm in runs:
                masks = torch.ones((n, N_SLOTS), device=where)
                masks[1, 150:] = 0.0
                feats[name] = Features(
                    fc_feats=torch.as_tensor(fc, device=where),
                    att_feats=torch.as_tensor(att, device=where),
                    att_masks=masks)
                before = tdk.stack_launches
                seqs[name] = cm.sample_beam(feats[name],
                                            beam_size=CAP_BEAM).seq[:, 0]
                if name == "gpu":
                    torch.cuda.synchronize()
                    launched = tdk.stack_launches - before
            # both models teacher-forced on the CPU's top beams
            for name, where, cm in runs:
                ctx, st = cm.make_decoder(feats[name])
                bos = torch.zeros((n,), dtype=torch.long, device=where)
                lps[name] = _incremental_logprobs(
                    cm.step, ctx, st, bos, seqs["cpu"].to(where)).cpu()
        if launched <= 0:
            raise AssertionError(f"{label} decode never launched "
                                 "transformer_decode_stack")
        err = (lps["gpu"] - lps["cpu"]).abs().max().item()
        same = int((seqs["gpu"].cpu() == seqs["cpu"]).all(1).sum())
        log(f"head width {label} (d {d} over {heads} heads, d_ff {dff}, "
            f"{HW_LAYERS} layers): beam {CAP_BEAM} on {n} images, {launched} "
            f"stack launches; card vs cpu teacher-forced logprobs max|diff| "
            f"{err:.3g} (tol {AGREE_TOL}); top beams token-identical "
            f"{same} of {n}")
        if not err <= AGREE_TOL or same != n:
            raise AssertionError(f"head width {label}: card and cpu "
                                 "decodes disagree")
        del cap, cap_c


# ---------------------------------------------------------------------------
# transformer captioner XE training
# ---------------------------------------------------------------------------

def _check_close(name: str, got, want) -> float:
    """max|diff| / max(1, max|plain|) over the pairs; raises above
    TRAIN_TOL."""
    err = _rel_err(got, want)
    if not err <= TRAIN_TOL:
        raise AssertionError(f"{name}: max|diff| / max(1, max|plain|) = "
                             f"{err} > {TRAIN_TOL}")
    return err


def _mha_inputs(dev, gen, b, t, s, kind, d):
    """q, g [B,T,d], k, v [B,S,d] at unit scale; the additive mask of the
    path: [B,1,S] with some images' slots padded, or the decoder's causal
    + pad [B,T,T] (position 0 always kept)."""
    import torch

    q, g = (torch.randn((b, t, d), generator=gen, device=dev) for _ in "qg")
    k, v = (torch.randn((b, s, d), generator=gen, device=dev) for _ in "kv")
    lengths = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    lengths[0] = s
    pos = torch.arange(s, device=dev)
    keep = (pos[None, :] < lengths[:, None])[:, None, :]            # [B,1,S]
    if kind == "causal":
        keep = (keep | (pos == 0)) & (pos[None, :] <= pos[:, None])[None]
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    return q, k, v, g, maskadd


def _ln_inputs(dev, gen, b, t, d):
    """x [B, T, d] around 1 at scale 3, scale 1 +- 0.1, offset and g."""
    import torch

    x = torch.randn((b, t, d), generator=gen, device=dev) * 3 + 1
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    offset = 0.1 * torch.randn((d,), generator=gen, device=dev)
    g = torch.randn((b, t, d), generator=gen, device=dev)
    return x, scale, offset, g


def phase_train_kernels(dev) -> dict:
    """The training attention and LayerNorm kernels against their plain
    versions at the training step's shapes, forward and backward, dropout
    on; each backward twice, bit for bit; the LayerNorm also at LN_WIDE.
    Returns the JSON records."""
    import torch
    import torch.nn.functional as F

    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.ops import ln_train as lno
    from unpaired_image_captioning_tpu_torch.ops import mha_train as mho

    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    rows = {n: [] for n in ("mha_train_fwd", "mha_train_bwd", "ln_train_fwd",
                            "ln_train_bwd")}
    errs = {n: 0.0 for n in rows}

    def timed(name, label, shape, kfn, pfn, kernel_names, by, flops,
              lib_fn, lib_what):
        k_ms, p_ms, k_wall, p_wall, how = time_pair(kfn, pfn, kernel_names)
        b_ms, b_by = bound(by, flops)
        lib_ms, lib_how = library_ms(lib_fn) if lib_fn else (None, "")
        rows[name].append(dict(label=label, shape=shape, ms=k_ms,
                               plain_ms=p_ms, wall_ms=k_wall,
                               plain_wall_ms=p_wall, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms, timing=how))
        lib_msg = (f"{lib_what} {lib_ms:.4f} ms ({lib_how})" if lib_fn
                   else lib_what)
        log(f"kernel {name} [{shape}] ({label}): {how}: kernel {k_ms:.4f} ms,"
            f" plain {p_ms:.4f} ms; per call kernel {k_wall:.4f} ms, plain "
            f"{p_wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}); library: "
            f"{lib_msg}")

    for label, b, t, s, kind, *width in MHA_SHAPES:
        d, heads = width or (TCAP["input_encoding_size"], TCAP["num_heads"])
        q, k, v, g, maskadd = _mha_inputs(dev, gen, b, t, s, kind, d)
        dh = d // heads
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
        out2, stats2 = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
        grads = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                                  **kw)
        again = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                                  **kw)
        ref = mho.mha_train_plain(q, k, v, maskadd, seed, **kw)
        ref_stats = mho.softmax_stats(q, k, maskadd, n_heads=heads)
        refs = mho.mha_train_plain_bwd(q, k, v, maskadd, seed, g, **kw)
        torch.cuda.synchronize()
        e_f = _check_close(f"mha_train_fwd {label}",
                           [out, stats[0], stats[1]],
                           [ref, ref_stats[0], ref_stats[1]])
        e_b = _check_close(f"mha_train_bwd {label}", grads, refs)
        if not (torch.equal(out, out2) and torch.equal(stats, stats2)):
            raise AssertionError(f"mha_train_fwd {label}: two runs differ")
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"mha_train_bwd {label}: two runs differ")
        errs["mha_train_fwd"] = max(errs["mha_train_fwd"], e_f)
        errs["mha_train_bwd"] = max(errs["mha_train_bwd"], e_b)
        shape = f"B={b} T={t} S={s} d={d} H={heads} rate={TRAIN_RATE}"
        log(f"kernel mha_train [{shape}] ({label}): max|diff| / max(1, "
            f"max|plain|) out and row stats {e_f:.3g}, dq/dk/dv {e_b:.3g} "
            f"(tol {TRAIN_TOL}); forward and backward twice: identical bits")
        # the unmasked scores this data needs: 2 FLOP a MAC over dh for
        # each of QK^T and AV (forward) and of the five backward products
        pairs = float((maskadd >= 0).expand(b, t, s).sum()) * heads
        # the yardstick: scaled_dot_product_attention at rate 0 on
        # [B,H,T,dh] views with the additive mask
        q4, k4, v4, g4 = (x.view(b, x.shape[1], heads, dh).transpose(1, 2)
                          for x in (q, k, v, g))
        m4 = maskadd[:, None]
        timed("mha_train_fwd", label, shape,
              lambda: mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw),
              lambda: mho.mha_train_plain(q, k, v, maskadd, seed, **kw),
              "mha_fwd_kernel", nbytes(q, k, v, maskadd, seed, out, stats),
              4.0 * pairs * dh,
              lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                     attn_mask=m4),
              "scaled_dot_product_attention, rate 0")
        lq, lk_, lv = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lout = F.scaled_dot_product_attention(lq, lk_, lv, attn_mask=m4)
        timed("mha_train_bwd", label, shape,
              lambda: mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out,
                                        stats, **kw),
              lambda: mho.mha_train_plain_bwd(q, k, v, maskadd, seed, g,
                                              **kw),
              MHA_BWD_KERNELS,
              nbytes(q, k, v, maskadd, seed, g, out, stats, *grads),
              10.0 * pairs * dh,
              lambda: torch.autograd.grad(lout, (lq, lk_, lv), g4,
                                          retain_graph=True),
              "scaled_dot_product_attention backward, rate 0")

    for label, b, t, d in LN_SHAPES + LN_WIDE:
        x, scale, offset, g = _ln_inputs(dev, gen, b, t, d)
        y = lnk.ln_train_fwd(x, scale, offset)
        grads = lnk.ln_train_bwd(x, scale, g)
        again = lnk.ln_train_bwd(x, scale, g)
        torch.cuda.synchronize()
        e_f = _check_close(f"ln_train_fwd {label}", [y],
                           [lno.ln_train_plain(x, scale, offset)])
        e_b = _check_close(f"ln_train_bwd {label}", grads,
                           lno.ln_train_plain_bwd(x, scale, g))
        if not all(torch.equal(p, r) for p, r in zip(grads, again)):
            raise AssertionError(f"ln_train_bwd {label}: two runs differ")
        errs["ln_train_fwd"] = max(errs["ln_train_fwd"], e_f)
        errs["ln_train_bwd"] = max(errs["ln_train_bwd"], e_b)
        shape = f"[{b}, {t}, {d}]"
        log(f"kernel ln_train {shape} ({label}): max|diff| / max(1, "
            f"max|plain|) y {e_f:.3g}, dx/d_scale/d_offset {e_b:.3g} (tol "
            f"{TRAIN_TOL}); backward twice: identical bits")
        # No PyTorch call computes this LayerNorm (unbiased variance, eps
        # outside the sqrt): F.layer_norm moves the same bytes and is
        # printed as that only.
        lx, ls, lo_ = (z.detach().requires_grad_() for z in (x, scale, offset))
        ly = F.layer_norm(lx, (d,), ls, lo_, 1e-6)
        same_fwd = library_ms(lambda: F.layer_norm(x, (d,), scale, offset,
                                                   1e-6))[0]
        same_bwd = library_ms(lambda: torch.autograd.grad(
            ly, (lx, ls, lo_), g, retain_graph=True))[0]
        n = float(b * t * d)
        timed("ln_train_fwd", label, shape,
              lambda: lnk.ln_train_fwd(x, scale, offset),
              lambda: lno.ln_train_plain(x, scale, offset), "ln_fwd_kernel",
              nbytes(x, scale, offset, y), 8.0 * n, None,
              "none computes this formula (F.layer_norm, same bytes, other "
              f"formula: {same_fwd:.4f} ms)")
        timed("ln_train_bwd", label, shape,
              lambda: lnk.ln_train_bwd(x, scale, g),
              lambda: lno.ln_train_plain_bwd(x, scale, g),
              LN_BWD_KERNELS,
              nbytes(x, scale, g, *grads), 14.0 * n, None,
              "none computes this formula (F.layer_norm backward, same "
              f"bytes, other formula: {same_bwd:.4f} ms)")

    src = "unpaired_image_captioning_tpu_torch/csrc/"
    where = {"mha_train_fwd": ("mha_train.cu", "mha_train.py:111"),
             "mha_train_bwd": ("mha_train.cu", "mha_train.py:125"),
             "ln_train_fwd": ("ln_train.cu", "ln_train.py:52"),
             "ln_train_bwd": ("ln_train.cu", "ln_train.py:60")}
    out = {}
    for name, rs in rows.items():
        main = rs[0]                                # the encoder's shape
        out[name] = {
            "name": name, "route": "cuda", "source": src + where[name][0],
            "replaces": "unpaired_image_captioning_tpu/ops/" + where[name][1],
            "max_abs_err": errs[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": f"{main['label']}: {main['shape']}",
            "timing": main["timing"],
            "err_is": "max|diff| / max(1, max|plain|)", "shapes": rs}
    return out


def _layer_weights(gen, dev, keys, d: int, f: int) -> dict:
    """Random layer weights at the init's scale: matrices uniform-like
    N(0, 1/d), biases and LayerNorm offsets N(0, 0.01), scales 1 +- 0.1."""
    import torch

    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d),
              "wq": (d, d), "wo2": (d, d), "w1": (d, f), "b1": (f,),
              "w2": (f, d)}
    w = {}
    for k in keys:
        r = torch.randn(shapes.get(k, (d,)), generator=gen, device=dev)
        if k.startswith("l") and k.endswith("s"):
            w[k] = 1 + 0.1 * r
        else:
            w[k] = r * (0.1 if k.startswith(("l", "b")) else d ** -0.5)
    return w


def _check_each(name: str, names, got, want,
                tol: float = TRAIN_TOL) -> float:
    """Per tensor: max|diff| / max(1, max|plain|) <= tol; returns the
    largest."""
    worst = 0.0
    for key, a, b in zip(names, got, want):
        e = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"{name}: {key} max|diff| / max(1, "
                                 f"max|plain|) = {e} > {tol}")
        worst = max(worst, e)
    return worst


def _relu_flips(name: str, xa, w: dict, hd, seed, heads: int,
                ln: str = "l2") -> None:
    """Where the kernel's FFN relu pattern (hd > 0) and the plain
    version's (pre-activation > 0, where the dropout keeps) differ, the
    plain pre-activation must lie within 1e-5 * max(1, max|h|) of 0:
    rounding on either side of the kink. Logs how many differ."""
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto
    from unpaired_image_captioning_tpu_torch.ops.ln_train import (
        ln_train_plain)
    from unpaired_image_captioning_tpu_torch.ops.mha_train import keep_mask

    b, t, f = hd.shape
    hlin = ln_train_plain(xa, w[ln + "s"], w[ln + "b"]) @ w["w1"] + w["b1"]
    keep = keep_mask(seed, b, heads, t, f, TRAIN_RATE, n_sites=lto.N_SITES,
                     site=2, heads=1)[:, 0]
    differ = ((hd > 0) != (hlin > 0)) & keep
    near = hlin.abs() <= 1e-5 * max(1.0, hlin.abs().max().item())
    if (differ & ~near).any():
        raise AssertionError(f"{name}: {int((differ & ~near).sum())} FFN "
                             "relu decisions differ away from the kink")
    log(f"kernel {name}: {int(differ.sum())} of {hd.numel()} FFN "
        "pre-activations fall on the other side of 0 than in the plain "
        "version, all within 1e-5 of it; the backward is compared on the "
        "kernel's relu pattern")


def _layer_module(dev, w: dict, d: int, f: int, decoder: bool):
    """The captioner's layer parameters (`enc_layer_init` /
    `dec_layer_init`) holding the weights w, for the per-sublayer route."""
    import torch

    from unpaired_image_captioning_tpu_torch.models import transformer as tm

    lp = (tm.dec_layer_init if decoder else tm.enc_layer_init)(d, f,
                                                               device=dev)
    with torch.no_grad():
        for i, k in enumerate("qkv"):
            lp["self"][k].w.copy_(w["wqkv"][:, i * d:(i + 1) * d])
            lp["self"][k].b.copy_(w["bqkv"][i * d:(i + 1) * d])
        lp["self"]["o"].w.copy_(w["wo"])
        lp["self"]["o"].b.copy_(w["bo"])
        if decoder:
            for k, wk, bk in (("q", "wq", "bq"), ("o", "wo2", "bo2")):
                lp["src"][k].w.copy_(w[wk])
                lp["src"][k].b.copy_(w[bk])
        for k in ("w1", "w2"):
            lp["ffn"][k].w.copy_(w[k])
            lp["ffn"][k].b.copy_(w["b" + k[1]])
        for n in ("n1", "n2", "n3") if decoder else ("n1", "n2"):
            lp[n].scale.copy_(w[f"l{n[1]}s"])
            lp[n].offset.copy_(w[f"l{n[1]}b"])
    return lp


def _yardsticks(label, fwd, params, g):
    """(forward ms, backward ms) of a differentiable callable as device
    time per call: the forward alone, then the backward of one recorded
    forward over `params` with cotangent g (parameters the callable does
    not use, such as the decoder's memory K/V projections, get none)."""
    import torch

    f_ms, _ = library_ms(fwd)
    out = fwd()
    b_ms, _ = library_ms(lambda: torch.autograd.grad(
        out, params, g, retain_graph=True, allow_unused=True))
    log(f"kernel {label}: forward {f_ms:.4f} ms, backward {b_ms:.4f} ms "
        "(device time)")
    return f_ms, b_ms


# a whole-layer wrapper's CUDA kernels by kind
LAYER_KINDS = {"gemm": ("gemm_kernel",), "attention": ("mha_",),
               "layernorm": ("ln_fwd", "ln_bwd"),
               "dropout": ("drop_kernel",),
               "weight transposes": ("weight_transpose",)}


def _kind_ms(parts: dict) -> dict:
    """A wrapper's device time per call by kind of CUDA kernel."""
    return {kind: sum(v for n, (v, _) in parts.items()
                      if any(k in n for k in keys))
            for kind, keys in LAYER_KINDS.items()}


def _split_parts(parts: dict) -> str:
    return ", ".join(f"{k} {ms:.4f}" for k, ms in _kind_ms(parts).items()
                     ) + " ms"


def _layer_gemms(acts: dict, w: dict, decoder: bool):
    """The products of one whole-layer forward and backward as
    (forward, backward) lists of (A, B) pairs on the layer's own weights
    and saved activations (acts: y1, ao, y2, hd, and the decoder's co and
    y3, each [M, cols]); the backward's dY operands are random tensors of
    their shapes. What `_cublas_gemms` times."""
    import torch

    m, d = acts["y1"].shape
    gen = torch.Generator(device=acts["y1"].device).manual_seed(3)

    def rnd(cols):
        return torch.randn((m, cols), generator=gen, device=gen.device)

    ffn_in = acts["y3"] if decoder else acts["y2"]
    fwd = [(acts["y1"], w["wqkv"]), (acts["ao"], w["wo"]),
           (ffn_in, w["w1"]), (acts["hd"], w["w2"])]
    df, dlin, dout, dqkv = (rnd(d), rnd(acts["hd"].shape[1]), rnd(d),
                            rnd(3 * d))
    bwd = [(acts["hd"].t(), df), (df, w["w2"].t()), (ffn_in.t(), dlin),
           (dlin, w["w1"].t()), (acts["ao"].t(), dout), (dout, w["wo"].t()),
           (acts["y1"].t(), dqkv), (dqkv, w["wqkv"].t())]
    if decoder:
        dco, dqc = rnd(d), rnd(d)
        fwd += [(acts["y2"], w["wq"]), (acts["co"], w["wo2"])]
        bwd += [(acts["co"].t(), dco), (dco, w["wo2"].t()),
                (acts["y2"].t(), dqc), (dqc, w["wq"].t())]
    return fwd, bwd


def _cublas_gemms(pairs):
    """Device time of torch.matmul (cuBLAS, TF32 off) over the pairs, and
    their operations: (ms, how read, flops). A yardstick of a layer's
    GEMMs that the port never calls."""
    import torch

    flops = sum(2.0 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in pairs)
    ms, how = library_ms(lambda: [torch.matmul(a, b) for a, b in pairs])
    return ms, how, flops


def _gemm_plans(pairs, bf: int = 0) -> str:
    """train_gemm.cuh's plan of each distinct product shape M x N x K (bf:
    on the bf16 tensor-core instance): the 128-row tiles run in whole
    rounds, K unsplit, and the rest with K split across clusters."""
    import ctypes

    from unpaired_image_captioning_tpu_torch.kernels import build

    out, seen = [], set()
    plan = (ctypes.c_int * 4)()
    for a, b in pairs:
        key = (a.shape[0], b.shape[1], a.shape[1])
        if key in seen:
            continue
        seen.add(key)
        build.check(build.load().layer_train_gemm_plan(*key, bf, plan),
                    "layer_train_gemm_plan")
        full, rows, cs, at_once = plan
        out.append(f"{key[0]}x{key[1]}x{key[2]}: {full} of {rows} row tiles "
                   f"unsplit, the rest in clusters of {cs} ({at_once} at "
                   "once)")
    return "; ".join(out)


def _enc_layer_inputs(dev, gen, b, s, d, f):
    """An encoder layer's x, g [B, S, d], key mask (image 1 padded past 150
    over N_SLOTS slots, else sources of 6-16 tokens) as keep and additive
    mask, the dropout seed and the weights; and what the padding is."""
    import torch

    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

    x, g = (torch.randn((b, s, d), generator=gen, device=dev)
            for _ in range(2))
    keep = torch.ones((b, 1, s), dtype=torch.bool, device=dev)
    if s == N_SLOTS:
        keep[1, :, 150:] = False
        pad = "image 1 padded past 150"
    else:
        lengths = torch.randint(6, s + 1, (b,), generator=gen, device=dev)
        keep = (torch.arange(s, device=dev)[None, None, :]
                < lengths[:, None, None])
        pad = "sources of 6-16 tokens"
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    w = _layer_weights(gen, dev, lto.ENC_WEIGHTS, d, f)
    return x, g, keep, maskadd, seed, w, pad


def phase_layer_kernels(dev) -> dict:
    """The whole-layer kernels against their plain versions, dropout 0.1,
    forward and backward, each backward twice bit for bit: the encoder layer
    (B6) at each of ENC_LAYER_SHAPES, the decoder layer (B7) at each of
    DEC_LAYER_SHAPES (T 17 causal + pad over S 196). Yardsticks beside
    each: the port's per-sublayer route over the same layer (the mha_train
    / ln_train kernels and cuBLAS, dropout from a generator), PyTorch's own
    pre-norm layer at the same widths (the same work in another formula:
    biased variance, eps inside the sqrt; the decoder layer also projects
    the memory's K/V), and cuBLAS (TF32 off) over the layer's products
    alone on the same weights and activations, beside the kernel's own
    GEMMs (its `train_gemm_kernel` launches). Returns the JSON records."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.models import transformer as tm
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

    gen = torch.Generator(device=dev).manual_seed(5)
    kw_rate = dict(rate=TRAIN_RATE)
    src = "unpaired_image_captioning_tpu_torch/csrc/layer_train.cu"
    tpu = "unpaired_image_captioning_tpu/ops/layer_train.py:"
    rec = {}

    def record(name, replaces, err, shape, timing, by, flops, sub_ms,
               torch_ms, torch_what, cublas):
        k_ms, p_ms, k_wall, p_wall, how, parts = timing
        b_ms, b_by = bound(by, flops)
        kinds = _kind_ms(parts)
        c_ms, c_how, g_flops = cublas
        g_ms = kinds["gemm"]
        rate = g_flops / g_ms / 1e9 if g_ms > 0 else float("nan")
        row = dict(label=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, err=err, timing=how,
                   wall_ms=k_wall, plain_wall_ms=p_wall, by_kind_ms=kinds,
                   gemms_ms=g_ms, gemms_cublas_ms=c_ms,
                   gemms_tflops=rate, yardsticks={
                       "sublayer_route_ms": sub_ms, "torch_layer_ms": torch_ms,
                       "torch_layer_is": torch_what})
        if name not in rec:
            rec[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": tpu + replaces[0],
                "replaces_all": [tpu + r for r in replaces],
                "max_abs_err": err,
                "err_is": "max|diff| / max(1, max|plain|)",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "shape": shape,
                "timing": how, "wall_ms": k_wall, "plain_wall_ms": p_wall,
                "yardsticks": row["yardsticks"], "shapes": [row]}
        else:
            rec[name]["shapes"].append(row)
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        log(f"kernel {name} [{shape}]: {how}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms; per call kernel {k_wall:.4f} ms, plain "
            f"{p_wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / 1e9:.1f} GFLOP); kernel by kind: {_split_parts(parts)}"
            f"; its GEMMs {g_ms:.4f} ms ({rate:.1f} TFLOP/s over "
            f"{g_flops / 1e9:.1f} GFLOP, {rate / (F32_FLOPS / 1e12):.2f} of "
            f"the f32 peak), cuBLAS over the same products {c_ms:.4f} ms "
            f"({c_how}; ours / cuBLAS {g_ms / c_ms:.2f}); yardsticks: "
            f"per-sublayer route {sub_ms:.4f} ms, {torch_what} "
            f"{torch_ms:.4f} ms; library: none computes this function")
        log(f"kernel {name} [{shape}] by CUDA kernel (ms a call, launches): "
            + "; ".join(f"{n[:90]} {v:.4f} ({c:g})" for n, (v, c) in
                        sorted(parts.items(), key=lambda e: -e[1][0])))

    def timed(kfn, pfn):
        parts = {}
        return time_pair(kfn, pfn, TRAIN_KERNELS, iters=5,
                         parts=parts) + (parts,)

    def sublayer(fn, args):
        """fn(*args) on the per-sublayer route (dropout from a generator)."""
        old = _route_flags(False, False)
        try:
            return fn(*args, training=True,
                      generator=torch.Generator(device=dev).manual_seed(0))
        finally:
            _route_flags(*old)

    # ---- encoder layer, at each shape
    for label, b, s, d, f, heads in ENC_LAYER_SHAPES:
        kw = dict(n_heads=heads, **kw_rate)
        dh = d // heads
        x, g, keep, maskadd, seed, w, pad = _enc_layer_inputs(dev, gen, b, s,
                                                              d, f)
        ws = [w[k] for k in lto.ENC_WEIGHTS]
        out, saved = ltk.enc_layer_fwd(x, maskadd, seed, w, **kw)
        grads = ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
        again = ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
        ref, x2 = lto.enc_fwd_plain(x, maskadd, seed, *ws, **kw)
        # the backward against the plain one on the kernel's relu pattern: a
        # pre-activation within rounding of 0 may fall either side of the
        # kink
        refs = lto.enc_bwd_plain(x, maskadd, seed, x2, g, *ws, **kw,
                                 relu_active=saved[-1] > 0)
        torch.cuda.synchronize()
        name = f"enc_layer_train ({label})"
        _relu_flips(name, x2, w, saved[-1], seed, heads)
        e_f = _check_each(f"{name} fwd", ("out", "x2"), (out, saved[0]),
                          (ref, x2))
        e_b = _check_each(f"{name} bwd", ("dx",) + lto.ENC_WEIGHTS, grads,
                          refs)
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            raise AssertionError(f"{name} bwd: two runs differ")
        shape = (f"{label}: B={b} T={s} d={d} d_ff={f} H={heads} "
                 f"rate={TRAIN_RATE}, {pad}")
        log(f"kernel enc_layer_train [{shape}]: max|diff| / max(1, "
            f"max|plain|) out/x2 {e_f:.3g}, dx and 12 weight gradients "
            f"{e_b:.3g} (tol {TRAIN_TOL}, each tensor); backward twice: "
            "identical bits")
        m = b * s
        acts = {"y1": saved[1].reshape(m, d), "ao": saved[3].reshape(m, d),
                "y2": saved[5].reshape(m, d), "hd": saved[6].reshape(m, f)}
        g_fwd, g_bwd = _layer_gemms(acts, w, decoder=False)
        log(f"kernel enc_layer_train [{label}] GEMM plans: "
            + _gemm_plans(g_fwd + g_bwd))
        cub_f, cub_b = _cublas_gemms(g_fwd), _cublas_gemms(g_bwd)
        del acts, g_fwd, g_bwd
        pairs = float((maskadd >= 0).expand(b, s, s).sum()) * heads
        proj = float(m) * (4 * d * d + 2 * d * f)
        lp = _layer_module(dev, w, d, f, decoder=False)
        xr = x.detach().requires_grad_()
        params = [xr] + list(lp.parameters())
        sub_f, sub_b = _yardsticks(
            f"enc layer [{label}], per-sublayer route (mha_train, ln_train, "
            "cuBLAS)",
            lambda: sublayer(tm.enc_layer_apply, (lp, xr, keep, heads)),
            params, g)
        ref_layer = torch.nn.TransformerEncoderLayer(
            d, heads, f, dropout=0.0, batch_first=True, norm_first=True,
            device=dev)
        tparams = [xr] + list(ref_layer.parameters())
        tor_f, tor_b = _yardsticks(
            f"enc layer [{label}], torch.nn.TransformerEncoderLayer("
            "norm_first, dropout 0)",
            lambda: ref_layer(xr, src_key_padding_mask=~keep[:, 0]), tparams,
            g)
        what = "torch.nn.TransformerEncoderLayer (same work, other formula)"
        record("enc_layer_train_fwd", ["131"], e_f, shape,
               timed(lambda: ltk.enc_layer_fwd(x, maskadd, seed, w, **kw),
                     lambda: lto.enc_fwd_plain(x, maskadd, seed, *ws, **kw)),
               nbytes(x, maskadd, seed, *ws, out, x2),
               2.0 * proj + 4.0 * pairs * dh, sub_f, tor_f, what, cub_f)
        record("enc_layer_train_bwd", ["163", "202"], e_b, shape,
               timed(lambda: ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g,
                                               **kw),
                     lambda: lto.enc_bwd_plain(x, maskadd, seed, x2, g, *ws,
                                               **kw)),
               nbytes(x, maskadd, seed, *ws, *saved, g, *grads),
               4.0 * proj + 10.0 * pairs * dh, sub_b, tor_b, what, cub_b)
        del out, saved, grads, again, ref, x2, refs, lp, ref_layer, xr
        del params, tparams

    # ---- decoder layer, at each shape
    for label, d, f, heads in DEC_LAYER_SHAPES:
        dh = d // heads
        kw = dict(n_heads=heads, **kw_rate)
        b, s = TRAIN["batch_size"], N_SLOTS
        t_dec = TRAIN["seq_length"] + 1
        x, g = (torch.randn((b, t_dec, d), generator=gen, device=dev)
                for _ in range(2))
        mk, mv = (torch.randn((b, s, d), generator=gen, device=dev)
                  for _ in range(2))
        keep = torch.ones((b, 1, s), dtype=torch.bool, device=dev)
        keep[1, :, 150:] = False
        pos = torch.arange(t_dec, device=dev)
        lengths = torch.randint(5, t_dec + 1, (b,), generator=gen,
                                device=dev)
        pad_ok = (pos[None, :] < lengths[:, None]) | (pos[None, :] == 0)
        tkeep = pad_ok[:, None, :] & (pos[None, :] <= pos[:, None])[None]
        tmask = torch.where(tkeep, 0.0, -1e9).contiguous()
        smask = torch.where(keep, 0.0, -1e9).contiguous()     # [B, 1, S]
        seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                             device=dev)
        w = _layer_weights(gen, dev, lto.DEC_WEIGHTS, d, f)
        ws = [w[k] for k in lto.DEC_WEIGHTS]
        args = (x, mk, mv, tmask, smask, seeds)
        out, saved = ltk.dec_layer_fwd(*args, w, **kw)
        grads = ltk.dec_layer_bwd(*args, w, saved, g, **kw)
        again = ltk.dec_layer_bwd(*args, w, saved, g, **kw)
        ref, x2, x3 = lto.dec_fwd_plain(*args, *ws, **kw)
        refs = lto.dec_bwd_plain(*args, x2, x3, g, *ws, **kw,
                                 relu_active=saved[-1] > 0)
        torch.cuda.synchronize()
        name = f"dec_layer_train ({label})"
        _relu_flips(name, x3, w, saved[-1], seeds[0:1], heads, "l3")
        e_f = _check_each(f"{name} fwd", ("out", "x2", "x3"),
                          (out, saved[0], saved[1]), (ref, x2, x3))
        e_b = _check_each(f"{name} bwd",
                          ("dx", "dmk", "dmv") + lto.DEC_WEIGHTS, grads, refs)
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            raise AssertionError(f"{name} bwd: two runs differ")
        shape = (f"{label}: B={b} T={t_dec} S={s} d={d} d_ff={f} "
                 f"H={heads} rate={TRAIN_RATE}, causal + pad, image 1 padded "
                 "past 150")
        log(f"kernel dec_layer_train [{shape}]: max|diff| / max(1, "
            f"max|plain|) out/x2/x3 {e_f:.3g}, dx/dmk/dmv and 18 weight "
            f"gradients {e_b:.3g} (tol {TRAIN_TOL}, each tensor); backward "
            "twice: identical bits")
        m = b * t_dec
        # saved: x2, x3, y1, qkv, ao, y2, qc, co, y3, the two stats, hd
        acts = {k: saved[i].reshape(m, -1) for k, i in
                (("y1", 2), ("ao", 4), ("y2", 5), ("co", 7), ("y3", 8),
                 ("hd", 11))}
        g_fwd, g_bwd = _layer_gemms(acts, w, decoder=True)
        log(f"kernel dec_layer_train [{label}] GEMM plans: "
            + _gemm_plans(g_fwd + g_bwd))
        cub_f, cub_b = _cublas_gemms(g_fwd), _cublas_gemms(g_bwd)
        del acts, g_fwd, g_bwd
        pairs = (float(tkeep.sum())
                 + float((smask >= 0).expand(b, t_dec, s).sum())) * heads
        proj = float(m) * (6 * d * d + 2 * d * f)
        lp = _layer_module(dev, w, d, f, decoder=True)
        xr, mkr, mvr = (a.detach().requires_grad_() for a in (x, mk, mv))
        params = [xr, mkr, mvr] + list(lp.parameters())
        sub_f, sub_b = _yardsticks(
            f"dec layer [{label}], per-sublayer route (mha_train, ln_train, "
            "cuBLAS)",
            lambda: sublayer(tm.dec_layer_apply,
                             (lp, xr, mkr, mvr, tkeep, keep, heads)),
            params, g)
        ref_layer = torch.nn.TransformerDecoderLayer(
            d, heads, f, dropout=0.0, batch_first=True, norm_first=True,
            device=dev)
        tparams = [xr, mkr] + list(ref_layer.parameters())
        causal = ~(pos[None, :] <= pos[:, None])
        tor_f, tor_b = _yardsticks(
            f"dec layer [{label}], torch.nn.TransformerDecoderLayer("
            "norm_first, dropout 0; memory [B, S, d], its K/V projected "
            "inside)",
            lambda: ref_layer(xr, mkr, tgt_mask=causal,
                              memory_key_padding_mask=~keep[:, 0]),
            tparams, g)
        what = ("torch.nn.TransformerDecoderLayer (same work plus the "
                "memory's K/V projections, other formula)")
        record("dec_layer_train_fwd", ["444"], e_f, shape,
               timed(lambda: ltk.dec_layer_fwd(*args, w, **kw),
                     lambda: lto.dec_fwd_plain(*args, *ws, **kw)),
               nbytes(*args, *ws, out, x2, x3),
               2.0 * proj + 4.0 * pairs * dh, sub_f, tor_f, what, cub_f)
        record("dec_layer_train_bwd", ["476", "163", "202"], e_b, shape,
               timed(lambda: ltk.dec_layer_bwd(*args, w, saved, g, **kw),
                     lambda: lto.dec_bwd_plain(*args, x2, x3, g, *ws, **kw)),
               nbytes(*args, *ws, *saved, g, *grads),
               4.0 * proj + 10.0 * pairs * dh, sub_b, tor_b, what, cub_b)
        del out, saved, grads, again, ref, x2, x3, refs, lp, ref_layer, xr
        del params, tparams
    return rec


def make_train_batch(rs, n: int) -> dict:
    """A host batch as the data loader gives it: features, att_masks (image
    1's slots padded past 150), labels [n, seq_length + 2] with the BOS
    column and random lengths, and their masks."""
    fc, att = make_features(rs, n)
    att_masks = np.ones((n, N_SLOTS), np.float32)
    att_masks[1:2, 150:] = 0.0
    t, v = TRAIN["seq_length"], TRAIN["vocab_size"]
    labels = np.zeros((n, t + 2), np.int64)
    masks = np.zeros((n, t + 2), np.float32)
    lengths = rs.randint(5, t + 1, n)
    lengths[0] = t
    for i, length in enumerate(lengths):
        labels[i, 1:1 + length] = rs.randint(1, v + 1, length)
        masks[i, :length + 2] = 1.0
    return {"fc_feats": fc, "att_feats": att, "att_masks": att_masks,
            "labels": labels, "masks": masks}


def _route_flags(enc_layer: bool, dec_layer: bool):
    """Set the captioner's training-route flags; returns their old values."""
    from unpaired_image_captioning_tpu_torch.models import transformer as tm

    old = (tm.TRAIN_LAYER_KERNEL, tm.TRAIN_DEC_LAYER_KERNEL)
    tm.TRAIN_LAYER_KERNEL, tm.TRAIN_DEC_LAYER_KERNEL = enc_layer, dec_layer
    return old


def _att_flags(**flags) -> dict:
    """Set the denseatt attention-route flags of `models/att.py`; returns
    their old values."""
    from unpaired_image_captioning_tpu_torch.models import att as am

    old = {k: getattr(am, k) for k in flags}
    for k, v in flags.items():
        setattr(am, k, v)
    return old


def _train_kernel_flag(train_kernel: bool):
    """Set `models.att.TRAIN_KERNEL`; returns its old value as a tuple."""
    return (_att_flags(TRAIN_KERNEL=train_kernel)["TRAIN_KERNEL"],)


def phase_train(route, counters: dict, detail: bool, *, cfg_dict=TRAIN,
                set_flags=_route_flags, kernel_names=TRAIN_KERNELS,
                model: str = "transformer", make_batch=None,
                trainer_kw=None, sc_flag: bool = False) -> tuple:
    """XE training (SCST with `sc_flag`) of full-width models (the
    transformer captioner by default) through `Trainer.train` (built on the
    card, its default, with `trainer_kw`) on one route (label, flags for
    `set_flags`, timed steps, launches a step): 2 warm-up and the route's
    timed steps on one random batch of 50 from `make_batch`
    (`make_train_batch` by default). Every loss must be finite and each
    step must launch each kernel the route's number of times; in XE the
    last loss must be below the first, in SCST the reward must be above 0
    in some step and the timed steps must change the captioner's
    parameters. Tokens a step: the captioner's 50 x 17 when it trains, plus
    the NMT's non-PAD target words. Returns (the launches of the timed
    steps, mean step wall in s, one step's device busy in ms or None); with
    `detail`, logs the step's largest device operations too."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    label, flags, steps, per_step = route
    old = set_flags(*flags)
    try:
        cfg = Config(**cfg_dict).finalize()
        trainer = Trainer(cfg, **(trainer_kw or {}))
        n_params = sum(p.numel() for m in (trainer.i2t_model,
                                           trainer.nmt_model)
                       if m is not None for p in m.parameters())
        batch = (make_batch or make_train_batch)(np.random.RandomState(0),
                                                 cfg.batch_size)
        losses = [trainer.train(batch, sc_flag=sc_flag)["total_loss"]
                  for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        if sc_flag:
            p0 = [p.detach().clone() for p in trainer.i2t_model.parameters()]

        def counts():
            return {k: getattr(mod, attr)
                    for k, (mod, attr) in counters.items()}

        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        walls, words, rewards = [], [], []
        for step in range(steps):
            before = counts()
            t0 = time.perf_counter()
            out = trainer.train(batch, sc_flag=sc_flag)     # host floats
            walls.append(time.perf_counter() - t0)
            losses.append(out["total_loss"])
            words.append(out.get("nmt_words", 0.0))
            rewards.append(out.get("avg_reward", 0.0))
            grew = {k: n - before[k] for k, n in counts().items()}
            if grew != per_step:
                raise AssertionError(f"training ({label}) step {step} "
                                     f"launched {grew}, expected {per_step}")
        launches = counts()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite training loss: {losses}")
        if sc_flag:
            moved = sum(not torch.equal(p, q) for p, q in
                        zip(trainer.i2t_model.parameters(), p0))
            log(f"training [{label}]: avg_reward "
                + ", ".join(f"{x:.4f}" for x in rewards)
                + f"; {moved} of {len(p0)} captioner parameters changed "
                "over the timed steps")
            if not max(rewards) > 0:
                raise AssertionError(f"SCST ({label}): every sample's reward "
                                     "was 0 in every step")
            if not moved:
                raise AssertionError(f"SCST ({label}): the steps left the "
                                     "captioner's parameters where they were")
        elif not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall on one batch: "
                                 f"{losses}")
        wall = statistics.mean(walls)
        cap_tokens = (cfg.batch_size * (cfg.seq_length + 1)
                      if cfg.i2t_train_flag else 0)
        nmt_words = statistics.mean(words)
        tokens = cap_tokens + nmt_words
        log(f"training [{label}]: {model} {'SCST' if sc_flag else 'XE'}, "
            f"{n_params / 1e6:.2f} M "
            f"parameters, batch {cfg.batch_size}, {steps} steps after "
            f"{TRAIN_WARMUP} warm-up: step wall mean {wall * 1e3:.1f} ms (min "
            f"{min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f}), "
            f"{tokens / wall:.0f} tokens/s ({tokens:.0f} a step: "
            f"{cap_tokens} caption, {nmt_words:.0f} NMT words); launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        log(f"training [{label}]: losses "
            + ", ".join(f"{x:.4f}" for x in losses))
        if detail:
            # the share of a step the host spends uploading the batch
            # (pageable numpy arrays, as train() receives them)
            host = [torch.as_tensor(v) for v in batch.values()
                    if not isinstance(v, dict)]
            t0 = time.perf_counter()
            for v in host:
                v.to(trainer.device)
            torch.cuda.synchronize()
            log(f"training [{model}]: uploading one batch "
                f"({nbytes(*host) / 1e6:.1f} "
                f"MB) takes {(time.perf_counter() - t0) * 1e3:.1f} ms of "
                "host wall")
        busy, per_name = device_ms(lambda: trainer.train(batch,
                                                         sc_flag=sc_flag))
        if busy is None:
            log(f"training [{label}]: device busy not measured (the profiler "
                "recorded no device time)")
            return launches, wall, None
        mine = sum(us for n, (us, _) in per_name.items()
                   if any(k in n for k in kernel_names)) / 1e3
        n_ops = sum(n for _, n in per_name.values())
        log(f"training [{label}]: one step device busy {busy:.1f} ms (kernel "
            f"time), idle share {1 - busy / (wall * 1e3):.2f} of the mean "
            f"step wall; {mine:.1f} ms ({mine / busy:.2f}) in the kernels of "
            f"csrc/; {n_ops} device operations in the step")
        if detail:
            for name, (us, n) in sorted(per_name.items(),
                                        key=lambda kv: -kv[1][0])[:TOP_OPS]:
                log(f"training [{model}]: device op {us / 1e3:8.3f} ms "
                    f"{n:6d}x  "
                    f"{name[:90]}")
        return launches, wall, busy
    finally:
        set_flags(*old)


def phase_train_agreement(dev, enc_layer: bool, dec_layer: bool,
                          widths: dict = None, label: str = "") -> None:
    """One training step on two images at full width, every dropout off,
    through `Trainer.train` on the card (kernels) and on the CPU (plain
    versions), from the same initial weights, on the route the flags name.
    The loss must agree within TRAIN_TOL relative and every updated
    parameter within TRAIN_TOL * max(1, max|p|). The step uses SGD at
    learning rate 1 after the global-norm clip, so the parameters move by
    the clipped gradient itself: Adam's first step would move each weight
    by about lr * sign(g) and turn the rounding noise of gradients that are
    zero in exact arithmetic (the attention key biases) into differences of
    2 * lr. `widths` overrides the captioner's widths (HEAD_WIDTHS); the
    card step must then launch the kernels of its route."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.models import transformer as tm
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    cfg = dict(TRAIN, batch_size=2, drop_prob_lm=0.0, i2t_optim="sgd",
               i2t_learning_rate=1.0, **(widths or {}))
    batch = make_train_batch(np.random.RandomState(4), 2)
    rate = tm.DROPOUT
    tm.DROPOUT = 0.0
    old = _route_flags(enc_layer, dec_layer)
    counts = (mhk, "fwd_launches"), (mhk, "bwd_launches"), (
        ltk, "enc_fwd_launches"), (ltk, "enc_bwd_launches"), (
        ltk, "dec_fwd_launches"), (ltk, "dec_bwd_launches")
    try:
        got = {}
        for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
            trainer = Trainer(Config(**cfg), device=device)
            before = [getattr(m, a) for m, a in counts]
            loss = trainer.train(batch)["total_loss"]
            if name == "gpu":
                launched = [getattr(m, a) - b
                            for (m, a), b in zip(counts, before)]
            got[name] = (loss, {k: v.detach().cpu() for k, v in
                                trainer.i2t_model.state_dict().items()})
    finally:
        tm.DROPOUT = rate
        _route_flags(*old)
    # the kernels the route must launch: the attentions per sublayer unless
    # every layer is whole; the layer kernels the flags name
    want = [not (enc_layer and dec_layer)] * 2 + [enc_layer] * 2 + [
        dec_layer] * 2
    if any(w and n <= 0 for w, n in zip(want, launched)):
        raise AssertionError(f"training step {label}: launches {launched} "
                             "miss a kernel of the route")
    (lg, pg), (lc, pc) = got["gpu"], got["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    worst, worst_key = 0.0, None
    for k, want in pc.items():
        e = (pg[k] - want).abs().max().item() / max(1.0,
                                                    want.abs().max().item())
        if e > worst:
            worst, worst_key = e, k
    route = ("whole encoder and decoder layers" if dec_layer and enc_layer
             else "whole encoder layers" if enc_layer else "per sublayer")
    if label:
        route += f", {label}"
    log(f"launches of the card step [{route}] (mha_train fwd / bwd, "
        f"enc_layer fwd / bwd, dec_layer fwd / bwd): {launched}")
    log(f"training agreement [{route}]: card vs cpu, one step on 2 images, "
        f"dropout 0: loss {lg:.6f} vs {lc:.6f} (relative {loss_err:.3g}); "
        f"updated parameters max|diff| / max(1, max|p|) {worst:.3g} at "
        f"{worst_key} (tol {TRAIN_TOL})")
    if not (loss_err <= TRAIN_TOL and worst <= TRAIN_TOL):
        raise AssertionError("card and cpu training steps disagree")


# ---------------------------------------------------------------------------
# denseatt: the additive-attention kernels, XE training and decoding
# ---------------------------------------------------------------------------

def _att_inputs(dev, gen, k=None, widths=None):
    """Attention inputs at the serving and training widths (B 50, N 196,
    A = D = 512; or widths = (B, N, A, D)): image 1's slots padded past
    150, image 2 fully masked."""
    import torch

    b, n, a, d = widths or (BENCH_BATCH, N_SLOTS, CAP["att_hid_size"],
                            CAP["rnn_size"])
    p_att = torch.randn((b, n, a), generator=gen, device=dev)
    q = torch.randn((b, a) if k is None else (b, k, a), generator=gen,
                    device=dev)
    alpha = torch.randn((a, 1), generator=gen, device=dev) / a ** 0.5
    mask = torch.ones((b, n), device=dev)
    mask[1, 150:] = 0.0
    mask[2] = 0.0
    emb = torch.randn((b, n, d), generator=gen, device=dev)
    return p_att, q, alpha, mask, emb


def _step_args(dev, gen, widths=None):
    """The fused decode step's 15 inputs (att -> maxout lstm1 -> att) at
    the serving widths (or widths = (B, N, A, D, H)), the memory padded and
    masked as `_att_inputs`'s."""
    import torch

    b, n, a, d, h = widths or (BENCH_BATCH, N_SLOTS, CAP["att_hid_size"],
                               CAP["rnn_size"], CAP["rnn_size"])
    p_att, _, alpha1, mask, emb = _att_inputs(dev, gen, None, (b, n, a, d))

    def uni(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                / fan ** 0.5)

    return [p_att, emb, mask,
            torch.randn((b, a), generator=gen, device=dev),      # q1
            *(torch.randn((b, h), generator=gen, device=dev)     # h0d, h1, c1
              for _ in range(3)),
            uni(2 * h + d, 5 * h, fan=h), uni(5 * h, fan=h),     # lstm1
            uni(d, h, fan=d), uni(h, fan=d),                     # emb2
            uni(h, a, fan=h), uni(a, fan=h),                     # h2att2
            alpha1, uni(a, 1, fan=a)]


def _att_check(name: str, got, want) -> float:
    """Each output: max|diff| / max(1, max|plain|) <= ATT_TOL; returns the
    largest."""
    worst = 0.0
    for a, b in zip(got, want):
        e = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        if not e <= ATT_TOL:
            raise AssertionError(f"{name}: max|diff| / max(1, max|plain|) = "
                                 f"{e} > {ATT_TOL}")
        worst = max(worst, e)
    return worst


def phase_att_kernels(dev, lstm_rec: dict) -> dict:
    """The three additive-attention kernels against their plain versions at
    the denseatt path's shapes, and the LSTM cell's backward against plain
    autograd at the training shape; returns the JSON records and adds the
    backward's numbers to `lstm_rec`."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.ops import attention as ao

    gen = torch.Generator(device=dev).manual_seed(7)
    src = "unpaired_image_captioning_tpu_torch/csrc/additive_attention.cu"
    tpu = "unpaired_image_captioning_tpu/ops/attention.py:"
    b, n, a = BENCH_BATCH, N_SLOTS, CAP["att_hid_size"]
    d = h = CAP["rnn_size"]
    rec = {}

    def record(name, line, err, shape, kfn, pfn, names, by, flops, trans,
               rows=None):
        k_ms, p_ms, k_wall, p_wall, how = time_pair(kfn, pfn, names)
        b_ms, term = bound(by, flops, trans)
        old_ms, old_by = bound(by, flops)
        # the JSON's bound_by names bytes or operations; a transcendental
        # bound is one of operations, and bound_term says which
        b_by = "bytes" if term == "bytes" else "operations"
        row = dict(label=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, bound_term=term, library_ms=None,
                   wall_ms=k_wall, plain_wall_ms=p_wall, timing=how, err=err,
                   bound_without_transcendentals_ms=old_ms)
        log(f"kernel {name} [{shape}]: max|diff| / max(1, max|plain|) "
            f"{err:.3g} (tol {ATT_TOL}); {how}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms; per call kernel {k_wall:.4f} ms, plain "
            f"{p_wall:.4f} ms; bound {b_ms:.4f} ms (set by {term}; "
            f"{trans / 1e6:.1f} M transcendentals; bytes and f32 operations "
            f"alone {old_ms:.4f} ms, {old_by}); library: no PyTorch call "
            "computes this function")
        if rows is not None:
            rows.append(row)
            return
        rec[name] = {"name": name, "route": "cuda", "source": src,
                     "replaces": tpu + line, "max_abs_err": err,
                     "err_is": "max|diff| / max(1, max|plain|)", "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_term": term, "library_ms": None, "shape": shape,
                     "timing": how, "shapes": [row]}

    def log_plan(k):
        log(f"additive_attention plan at B={b} N={n} A={a} D={d} K={k}: "
            + ", ".join(f"{key} {v}" for key, v in
                        aak.plan(b, n, a, d, k).items()))

    # B9a: one query per image
    log_plan(1)
    args = _att_inputs(dev, gen)
    out = aak.additive_attention(*args)
    want = ao.reference_attention(*args)
    torch.cuda.synchronize()
    err = _att_check("additive_attention", [out], [want])
    if out[2].any():
        raise AssertionError("additive_attention: the fully masked image "
                             "is not all zeros")
    record("additive_attention", "46", err,
           f"B={b} N={n} A={a} D={d}, image 1 padded past 150, image 2 "
           "fully masked", lambda: aak.additive_attention(*args),
           lambda: ao.reference_attention(*args), "additive_attention_kernel",
           nbytes(*args, out), 2.0 * b * n * (a + d), b * n * (a + 1.0))

    # B9b: K beam queries over unexpanded memory
    rows = []
    for k in ATT_BEAMS:
        log_plan(k)
        args = _att_inputs(dev, gen, k)
        out = aak.additive_attention_beams(*args)
        want = ao.reference_attention_beams(*args)
        torch.cuda.synchronize()
        err = _att_check(f"additive_attention_beams K={k}", [out], [want])
        record("additive_attention_beams", "66", err,
               f"B={b} K={k} N={n} A={a} D={d}, padded and masked as B9a",
               lambda: aak.additive_attention_beams(*args),
               lambda: ao.reference_attention_beams(*args),
               "additive_attention_kernel", nbytes(*args, out),
               2.0 * b * k * n * (a + d), b * k * n * (a + 1.0), rows)
    main = rows[ATT_BEAMS.index(CAP_BEAM)]              # the pivot's beam
    rec["additive_attention_beams"] = {
        "name": "additive_attention_beams", "route": "cuda", "source": src,
        "replaces": tpu + "66", "max_abs_err": max(r["err"] for r in rows),
        "err_is": "max|diff| / max(1, max|plain|)", "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "bound_term": main["bound_term"],
        "library_ms": None, "shape": main["label"], "timing": main["timing"],
        "shapes": rows}

    # B9c: att1 -> maxout lstm1 -> att2 of one decode step
    step = _step_args(dev, gen)
    with torch.no_grad():
        outs = aak.fused_att_lstm_att(*step)
        want = ao.att_lstm_att_plain(*step)
        torch.cuda.synchronize()
        err = _att_check("att_lstm_att", outs, want)
        record("att_lstm_att", "227", err,
               f"B={b} N={n} A={a} D={d} H={h}, padded and masked as B9a",
               lambda: aak.fused_att_lstm_att(*step),
               lambda: ao.att_lstm_att_plain(*step), STEP_KERNELS,
               nbytes(*step, *outs),
               2.0 * b * (2 * n * (a + d) + 3 * h * 5 * h + d * h + h * a),
               b * (2 * n * (a + 1.0) + 5 * h))
        before = aak.step_launches
        kernels_before = _launches_of(lambda: aak.fused_att_lstm_att(*step))
        log(f"att_lstm_att: {kernels_before} CUDA kernel launches a step "
            f"({aak.step_launches - before} step)")

    # B9a-c where one query's A and D do not fit a block (checked only)
    for wb, wn, wa, wd, wk, wh in ATT_WIDE:
        args = _att_inputs(dev, gen, None, (wb, wn, wa, wd))
        args_k = _att_inputs(dev, gen, wk, (wb, wn, wa, wd))
        step_w = _step_args(dev, gen, (wb, wn, wa, wd, wh))
        with torch.no_grad():
            errs = [_att_check(f"{name} at A={wa} D={wd}", [kf()], [pf()])
                    for name, kf, pf in (
                        ("additive_attention",
                         lambda: aak.additive_attention(*args),
                         lambda: ao.reference_attention(*args)),
                        ("additive_attention_beams",
                         lambda: aak.additive_attention_beams(*args_k),
                         lambda: ao.reference_attention_beams(*args_k)))]
            errs.append(_att_check(f"att_lstm_att at A={wa} D={wd}",
                                   aak.fused_att_lstm_att(*step_w),
                                   ao.att_lstm_att_plain(*step_w)))
        torch.cuda.synchronize()
        for name, e in zip(("additive_attention", "additive_attention_beams",
                            "att_lstm_att"), errs):
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], e)
        log(f"kernels B9a / B9b K={wk} / B9c at B={wb} N={wn} A={wa} D={wd} "
            f"H={wh} (one query's A and D past a block: chunks of A, passes "
            f"over D; plan {aak.plan(wb, wn, wa, wd, wk)}): max|diff| / "
            f"max(1, max|plain|) " + ", ".join(f"{e:.3g}" for e in errs)
            + f" (tol {ATT_TOL})")

    # the LSTM cell's backward (recompute + autodiff of the plain version)
    # at the denseatt training shape
    def uni(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                / fan ** 0.5)

    x_w = 2 * h
    w = uni(x_w + h, 5 * h, fan=h)
    bias = uni(5 * h, fan=h)
    x, h0, c0, gh, gc = (torch.randn((b, m), generator=gen, device=dev)
                         for m in (x_w, h, h, h, h))
    ins = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
    ref = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
    hk, ck = lk.lstm_cell(*ins, maxout=True)
    hp, cp = lk.lstm_cell_plain(*ref, maxout=True)
    if hk.grad_fn is None or ck.grad_fn is None:
        raise AssertionError("lstm_cell: a CUDA output carries no grad_fn")
    got = torch.autograd.grad((hk, ck), ins, (gh, gc), retain_graph=True)
    want = torch.autograd.grad((hp, cp), ref, (gh, gc), retain_graph=True)
    torch.cuda.synchronize()
    err = _att_check("lstm_cell backward", got, want)

    def bwd_k():
        return torch.autograd.grad((hk, ck), ins, (gh, gc), retain_graph=True)

    def bwd_p():
        return torch.autograd.grad((hp, cp), ref, (gh, gc), retain_graph=True)

    k_ms, _ = device_ms(bwd_k)
    p_ms, _ = device_ms(bwd_p)
    k_wall, p_wall = time_ms(bwd_k), time_ms(bwd_p)
    b_ms, b_by = bound(nbytes(w, bias, x, h0, c0, gh, gc, *got),
                       3 * 2.0 * b * (x_w + h) * 5 * h)
    shape = f"G=5 [{b}, {x_w}->{h}]"
    lstm_rec["backward"] = dict(
        shape=f"denseatt training: {shape}", err=err,
        err_is="max|diff| / max(1, max|plain|)", ms=k_ms, plain_ms=p_ms,
        wall_ms=k_wall, plain_wall_ms=p_wall, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    fmt = (lambda v: "not measured" if v is None else f"{v:.4f} ms")
    log(f"kernel lstm_cell backward {shape} (denseatt training): grad_fn "
        f"set; dw/db/dx/dh/dc max|diff| / max(1, max|plain|) {err:.3g} (tol "
        f"{ATT_TOL}); device: the Function's backward (gates recomputed by "
        f"the plain version, then autodiff) {fmt(k_ms)}, plain autograd "
        f"backward {fmt(p_ms)}; per call {k_wall:.4f} ms, plain "
        f"{p_wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}); library: none "
        "(maxout cell)")
    return rec


def _launches_of(fn) -> int:
    """The CUDA kernel launches (and copies) one call of `fn` makes, as
    torch.profiler records them."""
    per_name = _profile_device_us(fn) or {}
    return sum(n for _, n in per_name.values())


def phase_dense_train_agreement(dev, train_kernel: bool) -> None:
    """One denseatt training step on two images at full width, dropout
    off, SGD at learning rate 1 after the clip, through `Trainer.train` on
    the card and on the CPU from the same initial weights, on the route
    TRAIN_KERNEL names. The loss must agree within TRAIN_TOL relative and
    each parameter within TRAIN_TOL * max(1, max|p|), and every parameter
    that the step changes on the CPU must change on the card: a kernel
    whose output carries no gradient leaves everything upstream of it
    exactly where it was, on the card alone."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    cfg = dict(DTRAIN, batch_size=2, drop_prob_lm=0.0, i2t_optim="sgd",
               i2t_learning_rate=1.0)
    batch = make_train_batch(np.random.RandomState(4), 2)
    old = _train_kernel_flag(train_kernel)
    try:
        got = {}
        for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
            trainer = Trainer(Config(**cfg), device=device)
            model = trainer.i2t_model
            p0 = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
            loss = trainer.train(batch)["total_loss"]
            p1 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            got[name] = (loss, p0, p1)
    finally:
        _train_kernel_flag(*old)
    (lg, p0g, pg), (lc, p0c, pc) = got["gpu"], got["cpu"]
    if not all(torch.equal(p0g[k], p0c[k]) for k in p0c):
        raise AssertionError("card and cpu trainers start from other weights")
    loss_err = abs(lg - lc) / abs(lc)
    worst, worst_key = 0.0, None
    for k, want in pc.items():
        e = (pg[k] - want).abs().max().item() / max(1.0,
                                                    want.abs().max().item())
        if e > worst:
            worst, worst_key = e, k

    def moved(p1, p0, k):
        return not torch.equal(p1[k], p0[k])

    cpu_moved = [k for k in pc if moved(pc, p0c, k)]
    frozen = [k for k in cpu_moved if not moved(pg, p0g, k)]
    still = sorted(set(pc) - set(cpu_moved))
    route = "TRAIN_KERNEL" if train_kernel else "default"
    log(f"denseatt training agreement [{route}]: card vs cpu, one step on 2 "
        f"images, dropout 0: loss {lg:.6f} vs {lc:.6f} (relative "
        f"{loss_err:.3g}); updated parameters max|diff| / max(1, max|p|) "
        f"{worst:.3g} at {worst_key} (tol {TRAIN_TOL}); the step changes "
        f"{len(cpu_moved)} of {len(pc)} parameters on the cpu, "
        f"{len(cpu_moved) - len(frozen)} of them on the card too; unchanged "
        f"on the cpu: {', '.join(still) or 'none'}")
    if frozen:
        raise AssertionError(f"parameters that move on the cpu stay put on "
                             f"the card: {frozen}")
    if not (loss_err <= TRAIN_TOL and worst <= TRAIN_TOL):
        raise AssertionError("card and cpu denseatt training steps disagree")


# ---------------------------------------------------------------------------
# NMT training: the BiLSTM NMT, the joint step, the transformer NMT
# ---------------------------------------------------------------------------

def make_nmt_batch(rs, n: int) -> dict:
    """A host NMT batch as the NMT data set gives it: sources [n, 16] of
    random lengths (the first full) padded with PAD, targets [n, 18] of
    BOS, random words, EOS and PAD, and the source lengths."""
    sv, tv = NMT_TRAIN["nmt_src_vocab_size"], NMT_TRAIN["nmt_tgt_vocab_size"]
    lengths = rs.randint(6, NMT_SRC_LEN + 1, n)
    lengths[0] = NMT_SRC_LEN
    src = rs.randint(4, sv, (n, NMT_SRC_LEN))
    src[np.arange(NMT_SRC_LEN)[None, :] >= lengths[:, None]] = 0
    tgt = np.zeros((n, NMT_TGT_LEN), np.int64)
    words = rs.randint(4, NMT_TGT_LEN - 1, n)
    words[0] = NMT_TGT_LEN - 2
    for i, m in enumerate(words):
        tgt[i, 0] = NMT_BOS
        tgt[i, 1:1 + m] = rs.randint(4, tv, m)
        tgt[i, 1 + m] = NMT_EOS
    return {"nmt": {"src": src, "tgt": tgt, "lengths": lengths}}


def make_joint_batch(rs, n: int) -> dict:
    """A captioner batch (`make_train_batch`) with an NMT batch beside it."""
    return dict(make_train_batch(rs, n), **make_nmt_batch(rs, n))


def joint_trainer_kw(cfg_dict: dict) -> dict:
    """The joint step's couplings at full width: Weight_Trans over
    JOINT_ROWS captioner / NMT source rows, Weight_Trans_y against a frozen
    random [5000, 512] table on 2000 target rows, and a frozen teacher (a
    second NMT from seed 1) for the KLD, all made on the CPU."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
        make_nmt_model)

    rs = np.random.RandomState(12)
    cap_rows = 1 + rs.permutation(CAP["vocab_size"])[:JOINT_ROWS]
    src_rows = 4 + rs.permutation(NMT["src_vocab_size"] - 4)[:JOINT_ROWS]
    table = (rs.randn(5000, CAP["input_encoding_size"]) * 0.1).astype(
        np.float32)
    table_rows = rs.permutation(5000)[:2000]
    tgt_rows = 4 + rs.permutation(NMT["tgt_vocab_size"] - 4)[:2000]
    teacher = make_nmt_model(Config(**cfg_dict), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    return dict(joint_vocab=(cap_rows, src_rows),
                joint_vocab_y=(table, table_rows, tgt_rows),
                nmt_teacher=teacher.state_dict())


def phase_attention_memory(dev) -> None:
    """One full-width denseatt training step on the default route with the
    plain attention in two forms: recomputed in its autograd Function's
    hand-written backward (the port) and called directly (the form before
    the repair), in four turns of 3 steps in mirrored order (host walls
    vary too much for one turn). For each: the bytes kept for the backward
    (the distinct storages of the tensors autograd saves), the peak device
    memory and the step wall; then one attention call at the training
    shape, forward and backward, per call over 50 calls. The port's form
    must keep fewer bytes and peak lower than the direct call."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.models import att as am
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    trainer = Trainer(Config(**DTRAIN).finalize())
    batch = make_train_batch(np.random.RandomState(0), DTRAIN["batch_size"])
    trainer.train(batch)
    forms = {"recomputed": am._RecomputedAttend,
             "direct": types.SimpleNamespace(apply=am._attend)}
    got = {name: [] for name in forms}
    try:
        for name in list(forms) + list(forms)[::-1]:
            am._RecomputedAttend = forms[name]
            kept = {}

            def pack(t):
                st = t.untyped_storage()
                kept[st.data_ptr()] = st.nbytes()
                return t

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                trainer.train(batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
            got[name].append((sum(kept.values()) / 1e9, peak, wall))
    finally:
        am._RecomputedAttend = forms["recomputed"]
    del trainer

    # one call at the training shape: [B, N, A] = [50, 196, 512]
    gen = torch.Generator(device=dev).manual_seed(11)
    b, n, a = DTRAIN["batch_size"], N_SLOTS, CAP["att_hid_size"]
    ins = [torch.randn(shape, generator=gen, device=dev).requires_grad_()
           for shape in ((a, 1), (1,), (b, n, a), (b, a),
                         (b, n, CAP["rnn_size"]))]
    mask = torch.ones((b, n), device=dev)
    per_call = {name: time_ms(lambda f=form: f.apply(
        *ins[:4], mask, ins[4]).sum().backward(), iters=50)
        for name, form in forms.items()}

    def mean(name, i):
        return statistics.mean(r[i] for r in got[name])

    log(f"denseatt attention ({2 * _T1} calls a training step), kept for the "
        "backward / peak device memory / step wall, two turns of 3 steps "
        "each in mirrored order / one call forward + backward at "
        f"[{b}, {n}, {a}]: " + "; ".join(
            f"{name} {mean(name, 0):.3f} GB / {mean(name, 1):.3f} GB / "
            f"{mean(name, 2) * 1e3:.1f} ms ("
            + ", ".join(f"{r[2] * 1e3:.1f}" for r in got[name])
            + f") / {per_call[name]:.3f} ms" for name in forms))
    if not (mean("recomputed", 0) < mean("direct", 0)
            and mean("recomputed", 1) < mean("direct", 1)):
        raise AssertionError("the recomputing attention step does not keep "
                             "less memory")


def phase_nmt_train_agreement(dev, joint: bool) -> None:
    """One training step at full width on two sentences (and, joint, two
    images), dropout off, SGD at learning rate 1 after the clips, through
    `Trainer.train` on the card and on the CPU from the same initial
    weights: the BiLSTM NMT alone, or the joint step with its couplings.
    The loss must agree within TRAIN_TOL relative and each parameter
    within TRAIN_TOL * max(1, max|p|), and every parameter that the step
    changes on the CPU must change on the card (the first such check of the
    G=4 LSTM cell's gradient)."""
    base = JOINT_TRAIN if joint else NMT_TRAIN
    cfg = dict(base, batch_size=2, dropout=0.0, drop_prob_lm=0.0,
               i2t_optim="sgd", i2t_learning_rate=1.0, nmt_optim="sgd",
               nmt_learning_rate=1.0)
    rs = np.random.RandomState(4)
    batch = make_joint_batch(rs, 2) if joint else make_nmt_batch(rs, 2)
    kw = joint_trainer_kw(cfg) if joint else {}
    _step_agreement(dev, cfg, batch, kw, "joint denseatt + BiLSTM NMT"
                    if joint else "BiLSTM NMT")


def _step_agreement(dev, cfg: dict, batch: dict, kw: dict,
                    label: str) -> None:
    """One `Trainer.train` step of `cfg` on `batch` on the card and on the
    CPU from the same initial weights, held as
    `phase_nmt_train_agreement` says."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    def state(trainer):
        return {f"{name}.{k}": v.detach().cpu().clone()
                for name, m in (("i2t", trainer.i2t_model),
                                ("nmt", trainer.nmt_model)) if m is not None
                for k, v in m.state_dict().items()}

    got = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        trainer = Trainer(Config(**cfg), device=device, **kw)
        p0 = state(trainer)
        out = trainer.train(batch)
        got[name] = (out, p0, state(trainer))
    (og, p0g, pg), (oc, p0c, pc) = got["gpu"], got["cpu"]
    if not all(torch.equal(p0g[k], p0c[k]) for k in p0c):
        raise AssertionError("card and cpu trainers start from other weights")
    loss_err = abs(og["total_loss"] - oc["total_loss"]) / abs(oc["total_loss"])
    worst, worst_key = 0.0, None
    for k, want in pc.items():
        e = (pg[k] - want).abs().max().item() / max(1.0,
                                                    want.abs().max().item())
        if e > worst:
            worst, worst_key = e, k
    cpu_moved = [k for k in pc if not torch.equal(pc[k], p0c[k])]
    frozen = [k for k in cpu_moved if torch.equal(pg[k], p0g[k])]
    still = sorted(set(pc) - set(cpu_moved))
    terms = ", ".join(f"{k} {og[k]:.6f} vs {oc[k]:.6f}" for k in (
        "i2t_loss", "nmt_loss", "wemb_loss", "wemb_y_loss", "nmt_kld")
        if k in oc)
    log(f"training agreement [{label}]: card vs cpu, one step on "
        f"{cfg['batch_size']}, dropout "
        f"0: loss {og['total_loss']:.6f} vs {oc['total_loss']:.6f} (relative "
        f"{loss_err:.3g}; {terms}); updated parameters max|diff| / max(1, "
        f"max|p|) {worst:.3g} at {worst_key} (tol {TRAIN_TOL}); the step "
        f"changes {len(cpu_moved)} of {len(pc)} parameters on the cpu, "
        f"{len(cpu_moved) - len(frozen)} of them on the card too; unchanged "
        f"on the cpu: {', '.join(still) or 'none'}")
    if frozen:
        raise AssertionError(f"parameters that move on the cpu stay put on "
                             f"the card: {frozen}")
    if not (loss_err <= TRAIN_TOL and worst <= TRAIN_TOL):
        raise AssertionError(f"card and cpu {label} training steps disagree")


# ---------------------------------------------------------------------------
# SCST: on-device rewards, the self-critical loss, Trainer.train(sc_flag)
# ---------------------------------------------------------------------------

def make_scst_corpus(rs):
    """Caption rows [SCST_IMAGES * SCST_REFS, 16] of 8-16 words (0-padded)
    whose ranks follow p ~ 1 / rank over the captioner's vocabulary, with
    each image's 1-based inclusive row range (prepro_labels' layout)."""
    v, t = CAP["vocab_size"], CAP["seq_length"]
    p = 1.0 / np.arange(1, v + 1)
    n = SCST_IMAGES * SCST_REFS
    words = rs.choice(v, size=(n, t), p=p / p.sum()) + 1
    lengths = rs.randint(8, t + 1, n)
    labels = np.where(np.arange(t)[None, :] < lengths[:, None], words, 0)
    start = np.arange(SCST_IMAGES) * SCST_REFS + 1
    return labels.astype(np.int32), start, start + SCST_REFS - 1


def scst_gts(labels, n: int) -> dict:
    """The gts of the corpus's first n images and their masks."""
    return {"gts": labels[:n * SCST_REFS].reshape(n, SCST_REFS, -1),
            "gts_masks": np.ones((n, SCST_REFS), np.float32)}


def _given_seqs(rs, gts):
    """(gen, greedy) [B, 16] given sequences: gen row i is its reference
    i % 5 with a quarter of its words replaced and cut at 4-16 words;
    greedy rows are random words."""
    b, _, t = gts.shape
    v = CAP["vocab_size"]
    gen = gts[np.arange(b), np.arange(b) % SCST_REFS].astype(np.int64)
    swap = (rs.rand(b, t) < 0.25) & (gen > 0)
    gen = np.where(swap, rs.randint(1, v + 1, (b, t)), gen)
    gen[np.arange(t)[None, :] >= rs.randint(4, t + 1, b)[:, None]] = 0
    return gen, rs.randint(1, v + 1, (b, t)).astype(np.int64)


def phase_scst_rewards(dev, table, gts: dict) -> None:
    """CIDEr-D, BLEU-4 and the advantage on given sequences at the step's
    shapes ([50, 16] against gts [50, 5, 16]), card vs CPU within
    SCST_TOL * max(1, |cpu|); then the device time and launches of the
    reward as the trainer computes it (both CIDEr-D calls)."""
    import torch

    from unpaired_image_captioning_tpu_torch.losses.rewards import (
        get_self_critical_reward)
    from unpaired_image_captioning_tpu_torch.ops import cider as tc

    gen, greedy = _given_seqs(np.random.RandomState(7), gts["gts"])
    cpu_table = tc.DfTable(table.h1.cpu(), table.h2.cpu(), table.df.cpu(),
                           table.log_ref_len)
    host = [torch.from_numpy(np.asarray(x)) for x in (
        gen, greedy, gts["gts"], gts["gts_masks"])]
    on_dev = [x.to(dev) for x in host]
    fns = {"cider_d": lambda a, tab: tc.cider_d(a[0], a[2], a[3], tab),
           "bleu4": lambda a, tab: tc.bleu4(a[0], a[2], a[3]),
           "advantage": lambda a, tab: get_self_critical_reward(
               *a, tab)[0]}
    errs = {}
    for name, fn in fns.items():
        want = fn(host, cpu_table)
        got = fn(on_dev, table)
        if got.device != dev:
            raise AssertionError(f"SCST reward {name} left the card")
        errs[name] = float(((got.cpu() - want).abs()
                            / torch.clamp(want.abs(), min=1.0)).max())
        if name == "cider_d":
            scoring = int((want > 0).sum())
    log(f"SCST rewards: card vs cpu on given sequences [50, 16] against gts "
        f"[50, 5, 16] (df table of {SCST_IMAGES} x {SCST_REFS} captions, "
        f"{table.size} slots): max|diff| / max(1, |cpu|) "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {SCST_TOL}); CIDEr-D above 0 on {scoring} of 50 rows")
    if max(errs.values()) > SCST_TOL or not scoring:
        raise AssertionError("card and cpu SCST rewards disagree")
    busy, per_name = device_ms(lambda: get_self_critical_reward(*on_dev,
                                                                table))
    ms = time_ms(lambda: get_self_critical_reward(*on_dev, table), iters=20)
    log("SCST reward (sample and greedy, both CIDEr-D calls): "
        + (f"device {busy:.4f} ms in "
           f"{sum(n for _, n in per_name.values())} device operations"
           if busy is not None else "device time not measured")
        + f"; {ms:.4f} ms a call by CUDA events (host launches included)")


def phase_scst_rl_agreement(dev, cfg_dict: dict, label: str, table,
                            labels) -> None:
    """Card (kernels) vs CPU (plain versions) from the same initial weights
    at full width: the greedy `sample` of SCST_AGREE_IMAGES images (the
    baseline decode; identical tokens, logprobs within AGREE_TOL), then
    `Trainer._rl_loss` and its gradient on one given (gen, greedy) pair at
    the step's batch of 50: the loss within TRAIN_TOL relative, the
    samples' rewards within SCST_TOL and each parameter's gradient within
    TRAIN_TOL * max(1, max|g|)."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.ops import cider as tc
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    b = cfg_dict["batch_size"]
    batch = dict(make_train_batch(np.random.RandomState(4), b),
                 **scst_gts(labels, b))
    seqs = _given_seqs(np.random.RandomState(5), batch["gts"])
    cpu = torch.device("cpu")
    tables = {dev.type: table, "cpu": tc.DfTable(
        table.h1.cpu(), table.h2.cpu(), table.df.cpu(), table.log_ref_len)}
    n = SCST_AGREE_IMAGES
    got = {}
    for device in (dev, cpu):
        trainer = Trainer(Config(**cfg_dict), device=device,
                          df_table=tables[device.type])
        model = trainer.i2t_model
        p0 = {k: v.detach().cpu().clone() for k, v in
              model.state_dict().items()}
        up = trainer._batch(batch)
        feats = Features(fc_feats=up["fc_feats"], att_feats=up["att_feats"],
                         att_masks=up["att_masks"])
        few = Features(fc_feats=up["fc_feats"][:n],
                       att_feats=up["att_feats"][:n],
                       att_masks=up["att_masks"][:n])
        g_seq, g_lp = model.sample(few, greedy=True)
        loss, rewards = trainer._rl_loss(
            feats, *(torch.from_numpy(x).to(device) for x in seqs),
            up["gts"], up["gts_masks"])
        loss.backward()
        grads = {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).detach().cpu()
                 for k, p in model.named_parameters()}
        got[device.type] = (loss.item(), rewards.cpu(), grads, p0,
                            g_seq.cpu(), g_lp.cpu())
        del trainer, model, feats, loss
    (lg, rg, gg, p0g, sg, lpg), (lc, rc, gc, p0c, sc, lpc) = (
        got[dev.type], got["cpu"])
    if not all(torch.equal(p0g[k], p0c[k]) for k in p0c):
        raise AssertionError("card and cpu trainers start from other weights")
    same = torch.equal(sg, sc)
    gap = float((lpg - lpc).abs().max())
    log(f"SCST greedy agreement [{label}]: {n} images card vs cpu, tokens "
        f"{'identical' if same else 'DIFFER'}, logprobs max|diff| "
        f"{gap:.3g} (tol {AGREE_TOL}), {_greedy_steps(sc)} steps")
    if not (same and gap <= AGREE_TOL):
        raise AssertionError(f"card and cpu greedy samples disagree "
                             f"({label})")
    loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
    reward_err = float((rg - rc).abs().max())
    worst, worst_key = 0.0, None
    for k, want in gc.items():
        e = float((gg[k] - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        if e > worst:
            worst, worst_key = e, k
    nonzero = sum(bool(g.abs().max() > 0) for g in gc.values())
    log(f"SCST loss agreement [{label}]: card vs cpu, _rl_loss on given "
        f"sequences, {b} images: loss {lg:.6f} vs {lc:.6f} (relative "
        f"{loss_err:.3g}, tol {TRAIN_TOL}); rewards max|diff| "
        f"{reward_err:.3g} (tol {SCST_TOL}), mean {float(rc.mean()):.4f}; "
        f"gradients max|diff| / max(1, max|g|) {worst:.3g} at {worst_key} "
        f"(tol {TRAIN_TOL}); {nonzero} of {len(gc)} gradients nonzero on "
        "the cpu")
    if not (loss_err <= TRAIN_TOL and worst <= TRAIN_TOL
            and reward_err <= SCST_TOL and lc != 0.0 and nonzero):
        raise AssertionError(f"card and cpu SCST losses disagree ({label})")


def phase_scst_step_fusion(dev, table, labels) -> int:
    """The STEP_FUSION repair: one denseatt SCST step at batch 50 with the
    flag set, then the same step from the same seed and table on the
    default route. With the flag the decodes (no gradient) launch the
    fused step once a decode step, and the recompute (under grad) takes
    the unfused route, so both steps must sample the same tokens and give
    the same loss within TRAIN_TOL relative. Returns the fused step's
    launches in that step."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    batch = dict(make_train_batch(np.random.RandomState(0), 50),
                 **scst_gts(labels, 50))

    def step(flags):
        trainer = Trainer(Config(**DTRAIN), df_table=table)
        model, seqs = trainer.i2t_model, []

        def recording(*a, **k):
            out = type(model).sample(model, *a, **k)
            seqs.append(out[0].cpu())
            return out

        model.sample = recording
        old = _att_flags(**flags)
        try:
            aak.step_launches = 0
            out = trainer.train(batch, sc_flag=True)
            torch.cuda.synchronize()
            n = aak.step_launches
        finally:
            _att_flags(**old)
            del model.sample
        return out, n, seqs

    fused, n, seqs_f = step({"STEP_FUSION": True})
    plain, n_plain, seqs_p = step({})
    want = sum(_greedy_steps(s) for s in seqs_f)
    same = len(seqs_f) == len(seqs_p) == 2 and all(
        torch.equal(a, b) for a, b in zip(seqs_f, seqs_p))
    lf, lp = fused["total_loss"], plain["total_loss"]
    err = abs(lf - lp) / max(abs(lp), 1e-30)
    log(f"SCST with STEP_FUSION: one denseatt step at batch 50, loss "
        f"{lf:.6f}, avg_reward {fused['avg_reward']:.4f}; {n} fused "
        f"decode-step launches (expected {want}: sample "
        f"{_greedy_steps(seqs_f[0])} + greedy {_greedy_steps(seqs_f[1])} "
        f"steps); the default route from the same seed: loss {lp:.6f} "
        f"(relative {err:.3g}, tol {TRAIN_TOL}), avg_reward "
        f"{plain['avg_reward']:.4f}, tokens of both decodes "
        f"{'identical' if same else 'DIFFER'}, {n_plain} fused launches")
    if not (n == want and n_plain == 0 and same and err <= TRAIN_TOL
            and np.isfinite(lf)):
        raise AssertionError("the STEP_FUSION SCST step disagrees with the "
                             "default route or launched the fused step "
                             "another number of times")
    return n


def phase_scst(dev) -> dict:
    """SCST on the card: the df table from the port's prepro_ngrams over a
    seeded corpus, the rewards and the loss card vs CPU, 2 + 5 steps of
    `Trainer.train(sc_flag=True)` on denseatt and on the transformer
    captioner at batch 50, 2 + 2 joint steps with the BiLSTM NMT, and the
    STEP_FUSION step. Returns the launches of the timed steps of each
    family by kernel."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops.cider import build_df_table
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)

    t0 = time.perf_counter()
    labels, start, end = make_scst_corpus(np.random.RandomState(0))
    df, n_img = compute_df(labels, start, end)
    t1 = time.perf_counter()
    table = build_df_table(df, float(n_img), dev)
    torch.cuda.synchronize()
    log(f"SCST df table: {len(df)} n-grams over {n_img} images x "
        f"{SCST_REFS} captions, {table.size} slots on the card; compute_df "
        f"{t1 - t0:.2f} s, build_df_table {time.perf_counter() - t1:.2f} s "
        "(host)")
    marks = [("df table", time.perf_counter())]
    phase_scst_rewards(dev, table, scst_gts(labels, 50))
    marks.append(("rewards", time.perf_counter()))
    for cfg_dict, label in ((DTRAIN, "denseatt"), (TRAIN, "transformer")):
        phase_scst_rl_agreement(dev, cfg_dict, label, table, labels)
        marks.append((f"{label} loss card vs cpu", time.perf_counter()))

    def batch_of(make):
        return lambda rs, n: dict(make(rs, n), **scst_gts(labels, n))

    kw = dict(detail=False, sc_flag=True, trainer_kw={"df_table": table})
    dense = phase_train(SCST_ROUTES[0], {"lstm_cell": (lk, "launches")},
                        cfg_dict=DTRAIN, set_flags=_train_kernel_flag,
                        kernel_names=DENSE_KERNELS, model="denseatt",
                        make_batch=batch_of(make_train_batch), **kw)
    marks.append(("denseatt steps", time.perf_counter()))
    trans = phase_train(SCST_ROUTES[1], {"transformer_decode_stack": (
                            tdk, "stack_launches")},
                        kernel_names=TFD_KERNELS, model="transformer",
                        make_batch=batch_of(make_train_batch), **kw)
    marks.append(("transformer steps", time.perf_counter()))
    joint_kw = dict(joint_trainer_kw(JOINT_TRAIN), df_table=table)
    phase_train(SCST_JOINT_ROUTE, {"lstm_cell": (lk, "launches")},
                cfg_dict=JOINT_TRAIN, set_flags=_train_kernel_flag,
                kernel_names=DENSE_KERNELS, model="denseatt + BiLSTM NMT",
                make_batch=batch_of(make_joint_batch), detail=False,
                sc_flag=True, trainer_kw=joint_kw)
    marks.append(("joint steps", time.perf_counter()))
    phase_scst_step_fusion(dev, table, labels)
    marks.append(("STEP_FUSION step", time.perf_counter()))
    log("SCST phase seconds: " + ", ".join(
        f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t) in zip(
            [("start", t0)] + marks, marks)))
    return {"lstm_cell": dense[0]["lstm_cell"],
            "transformer_decode_stack": trans[0]["transformer_decode_stack"]}


def _b9_share(busy, parts) -> str:
    """The device time of a profiled call, and the share in B9's CUDA
    kernels (the attention core; the fused step's products and cells)."""
    if busy is None:
        return "not measured (the profiler recorded no device time)"
    out = [f"{busy:.3f} ms busy"]
    for name in ("additive_attention_kernel", "decode_gemm_kernel",
                 "lstm_cell_kernel"):
        us = sum(v for n, (v, _) in parts.items() if name in n)
        k = sum(c for n, (_, c) in parts.items() if name in n)
        if k:
            out.append(f"{name} {us / 1e3:.4f} ms in {k} launches")
    return "; ".join(out)


def _greedy_steps(seq) -> int:
    """Decode steps a greedy batch ran: the loop stops after the step in
    which the last row emitted EOS (0)."""
    return min(seq.shape[1], int((seq > 0).sum(1).max()) + 1)


GREEDY_ROUTES = [("default", {}), ("SINGLE_KERNEL", {"SINGLE_KERNEL": True}),
                 ("STEP_FUSION", {"STEP_FUSION": True})]


def phase_dense_decode(dev, cap, nmt, zh_vocab, cap2nmt) -> dict:
    """Greedy `sample` of the full-width denseatt captioner at batch 50 on
    the default route, with SINGLE_KERNEL and with STEP_FUSION; beam 5 with
    BEAMS_KERNEL through a batch-50 `pivot_translate`, beside the default
    route; exact launch counts against the steps each decode ran; four
    images against the CPU on each route (identical tokens, logprobs within
    AGREE_TOL); `CaptionService(greedy=True)` answering requests through
    the micro-batcher and HTTP. Returns each kernel's launches."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.pivot import pivot_translate
    from unpaired_image_captioning_tpu_torch.serve import (CaptionService,
                                                           make_http_server)

    def feats(fc, att, d):
        masks = torch.ones(att.shape[:2], device=d)
        masks[1, 150:] = 0.0
        return Features(fc_feats=torch.as_tensor(fc, device=d),
                        att_feats=torch.as_tensor(att, device=d),
                        att_masks=masks)

    f = feats(*make_features(np.random.RandomState(6), BENCH_BATCH), dev)
    launches = {}
    walls = {}
    for label, flags in GREEDY_ROUTES:
        old = _att_flags(**flags)
        try:
            with torch.inference_mode():
                cap.sample(f)                                   # warm-up
                torch.cuda.synchronize()
                aak.launches = aak.step_launches = 0
                t0 = time.perf_counter()
                seq, lp = cap.sample(f)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
                got = {"additive_attention": aak.launches,
                       "att_lstm_att": aak.step_launches}
                if flags:    # the kernels' device time on the path
                    busy, parts = device_ms(lambda: cap.sample(f))
                    log(f"denseatt greedy [{label}]: one decode's device "
                        f"time {_b9_share(busy, parts)}")
        finally:
            _att_flags(**old)
        steps = _greedy_steps(seq)
        want = {"additive_attention": 2 * steps if flags.get("SINGLE_KERNEL")
                else 0, "att_lstm_att": steps if flags.get("STEP_FUSION")
                else 0}
        if got != want:
            raise AssertionError(f"greedy [{label}]: launches {got}, "
                                 f"expected {want} for {steps} steps")
        if not (bool(torch.isfinite(lp).all()) and seq.shape == (
                BENCH_BATCH, CAP["seq_length"])):
            raise AssertionError(f"greedy [{label}]: bad output")
        launches.update({k: v for k, v in got.items() if v})
        log(f"denseatt greedy [{label}]: batch {BENCH_BATCH}, {steps} steps, "
            f"host wall {walls[label] * 1e3:.1f} ms (default route "
            f"{walls['default'] * 1e3:.1f} ms); launches "
            + ", ".join(f"{k} {v}" for k, v in got.items()))

    # beam 5 through the LSTM pivot, BEAMS_KERNEL against the default route
    c2n = torch.as_tensor(cap2nmt, device=dev)
    calls = {"cap": 0}

    def pivot():
        return pivot_translate(cap, nmt, f, c2n, cap_beam=CAP_BEAM,
                               nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)

    beam_wall = {}
    for label, flags in (("default", {}), ("BEAMS_KERNEL",
                                           {"BEAMS_KERNEL": True})):
        old = _att_flags(**flags)
        try:
            with torch.inference_mode():
                pivot()
                torch.cuda.synchronize()
                aak.beams_launches = 0
                calls["cap"] = 0
                _count_calls(cap, "step", calls, "cap")
                try:
                    t0 = time.perf_counter()
                    zh, _, _ = pivot()
                    torch.cuda.synchronize()
                    beam_wall[label] = time.perf_counter() - t0
                finally:
                    del cap.step
                n_beams = aak.beams_launches
                if flags:    # the kernels' device time on the path
                    busy, parts = device_ms(pivot)
                    log(f"denseatt beam {CAP_BEAM} [{label}]: one "
                        f"pivot_translate's device time "
                        f"{_b9_share(busy, parts)}")
        finally:
            _att_flags(**old)
        want = 2 * calls["cap"] if flags else 0
        if n_beams != want:
            raise AssertionError(f"beam 5 [{label}]: additive_attention_beams "
                                 f"launched {n_beams} times in {calls['cap']} "
                                 f"caption steps; expected {want}")
        if flags:
            launches["additive_attention_beams"] = n_beams
        log(f"denseatt beam {CAP_BEAM} [{label}]: batch-{BENCH_BATCH} "
            f"pivot_translate host wall {beam_wall[label] * 1e3:.1f} ms "
            f"(default route {beam_wall['default'] * 1e3:.1f} ms), "
            f"{calls['cap']} caption steps; additive_attention_beams launches "
            f"{n_beams}")

    # four images against the CPU on each route
    n = 4
    fc4, att4 = make_features(np.random.RandomState(7), n)
    cpu = torch.device("cpu")
    cap_c = copy.deepcopy(cap).to(cpu)
    fg, fcpu = feats(fc4, att4, dev), feats(fc4, att4, cpu)
    for label, flags in GREEDY_ROUTES + [(f"BEAMS_KERNEL beam {CAP_BEAM}",
                                          {"BEAMS_KERNEL": True})]:
        old = _att_flags(**flags)
        try:
            with torch.inference_mode():
                if flags.get("BEAMS_KERNEL"):
                    rg = cap.sample_beam(fg, beam_size=CAP_BEAM)
                    rc = cap_c.sample_beam(fcpu, beam_size=CAP_BEAM)
                    (sg, lg), (sc, lc) = (rg.seq, rg.logps), (rc.seq, rc.logps)
                else:
                    (sg, lg), (sc, lc) = cap.sample(fg), cap_c.sample(fcpu)
        finally:
            _att_flags(**old)
        gap = (lg.cpu() - lc).abs().max().item()
        same = torch.equal(sg.cpu(), sc)
        log(f"denseatt agreement [{label}]: {n} images card vs cpu, tokens "
            f"{'identical' if same else 'DIFFER'}, logprobs max|diff| "
            f"{gap:.3g} (tol {AGREE_TOL})")
        if not (same and gap <= AGREE_TOL):
            raise AssertionError(f"denseatt [{label}]: card and cpu disagree")
    del cap_c

    # the greedy caption service: concurrent requests and one POST /caption
    fc, att = make_features(np.random.RandomState(8), 8)
    svc = CaptionService(cap, zh_vocab, greedy=True, max_batch=MAX_BATCH)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        lk.launches = 0
        answers = [None] * len(fc)

        def one(i):
            answers[i] = svc.caption(fc[i], att[i], timeout=600)

        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(fc))]
        for w_ in workers:
            w_.start()
        for w_ in workers:
            w_.join(600)
        batches = svc.batcher.stats["batches"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/caption",
            data=json.dumps({"fc": fc[0].tolist(),
                             "att": att[0].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_answer = json.loads(r.read())["caption"]
        direct = svc.caption(fc[0], att[0], timeout=600)
        torch.cuda.synchronize()
        cells = lk.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
        svc.close()
    if not all(isinstance(x, str) for x in answers) or cells <= 0:
        raise AssertionError("the greedy caption service did not answer "
                             "every request on the card")
    if http_answer != direct:
        raise AssertionError(f"HTTP answer {http_answer!r} != direct "
                             f"{direct!r}")
    log(f"denseatt CaptionService(greedy=True): {len(fc)} concurrent "
        f"requests in {batches} micro-batches, then POST /caption == "
        f"direct; lstm_cell launches {cells}; sample answer "
        f"{json.dumps(answers[0], ensure_ascii=False)}")
    return launches


# ---------------------------------------------------------------------------
# the raw-image path (B11 -> ResNet-101 -> LSTM pivot) and the blocked LSTM
# chain (B10)
# ---------------------------------------------------------------------------

def _img_input(dev, b, h, w, c=3):
    """Seeded uint8 images [B, H, W, C] on the host and on the card."""
    import torch

    host = np.random.RandomState(h).randint(
        0, 256, (b, h, w, c)).astype(np.uint8)
    return host, torch.from_numpy(host).to(dev)


def phase_image_kernel(dev) -> dict:
    """B11 against its plain version at a general downscale and at the
    loader's identity size (there bit-equal to the host's
    `preprocess_images`), then at IMG_WIDTHS (checked only); F.interpolate
    as the resize's yardstick."""
    import torch
    import torch.nn.functional as F

    from unpaired_image_captioning_tpu_torch.kernels import image as ik
    from unpaired_image_captioning_tpu_torch.ops import image as io

    rows, worst = [], 0.0
    for label, b, h, w, out in IMG_CASES:
        host, x = _img_input(dev, b, h, w)

        def kern():
            return ik.resize_normalize(x, h_out=out, w_out=out)

        def plain():
            return io.resize_normalize_plain(x, h_out=out, w_out=out)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = _check_each(f"image_front_end {label}", ["out"], [got], [want],
                          IMG_TOL)
        worst = max(worst, err)
        exact = ""
        if (h, w) == (out, out):
            if not np.array_equal(got.cpu().numpy(),
                                  io.preprocess_images(host)):
                raise AssertionError("image_front_end at the identity is not "
                                     "bit-equal to preprocess_images")
            exact = "; bit-equal to preprocess_images"
        k_ms, p_ms, k_wall, p_wall, how = time_pair(kern, plain,
                                                    "front_end_kernel")
        # uint8 read once, f32 written once; 12 operations an output (two
        # taps in each direction, the normalisation)
        b_ms, b_by = bound(nbytes(x, got), 12.0 * got.numel())
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        lib_ms, lib_how = library_ms(lambda: F.interpolate(
            xf, size=(out, out), mode="bilinear", align_corners=False,
            antialias=False))
        shape = f"[{b}, {h}, {w}, 3] -> {out}x{out}"
        rows.append(dict(label=label, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, timing=how,
                         shape=shape))
        log(f"kernel image_front_end {shape} ({label}): max|diff| / max(1, "
            f"max|plain|) {err:.3g} (tol {IMG_TOL}){exact}; {how}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per call kernel "
            f"{k_wall:.4f} ms, plain {p_wall:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}); library: F.interpolate bilinear on f32 NCHW (the "
            f"resize alone) {lib_ms:.4f} ms ({lib_how})")
    for label, b, h, w, c, ho, wo in IMG_WIDTHS:
        host, x = _img_input(dev, b, h, w, c)
        got = ik.resize_normalize(x, h_out=ho, w_out=wo)
        want = io.resize_normalize_plain(x, h_out=ho, w_out=wo)
        torch.cuda.synchronize()
        err = _check_each(f"image_front_end {label}", ["out"], [got], [want],
                          IMG_TOL)
        worst = max(worst, err)
        exact = ""
        if (h, w) == (ho, wo):
            if not np.array_equal(got.cpu().numpy(),
                                  io.preprocess_images(host)):
                raise AssertionError(f"image_front_end {label}: not "
                                     "bit-equal to preprocess_images")
            exact = "; bit-equal to preprocess_images"
        log(f"kernel image_front_end [{b}, {h}, {w}, {c}] -> {ho}x{wo} "
            f"({label}): max|diff| / max(1, max|plain|) {err:.3g} (tol "
            f"{IMG_TOL}){exact}")
    main = rows[0]
    return {"image_front_end": {
        "name": "image_front_end", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/image_front_end.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/image.py:46",
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "F.interpolate(bilinear, align_corners=False, "
                   "antialias=False) on f32 NCHW: the resize alone",
        "shape": f"{main['label']}: {main['shape']}",
        "timing": main["timing"], "shapes": rows}}


def _chain_inputs(dev, gen, g: int):
    """The lstm0 fragment's inputs: the fused cell weight [D+H, G*H] and
    bias, time-major inputs [T, B, D], h0, c0, and loss cotangents for hs
    and cs."""
    import torch

    b, t, d, h = CHAIN_SHAPE
    scale = 1.0 / h ** 0.5
    w = (torch.rand((d + h, g * h), generator=gen, device=dev) * 2 - 1) * scale
    bias = (torch.rand((g * h,), generator=gen, device=dev) * 2 - 1) * scale
    x = torch.randn((t, b, d), generator=gen, device=dev)
    h0 = torch.randn((b, h), generator=gen, device=dev) * 0.5
    c0 = torch.randn((b, h), generator=gen, device=dev) * 0.5
    ch = torch.randn((t, b, h), generator=gen, device=dev)
    cc = torch.randn((t, b, h), generator=gen, device=dev) * 0.3
    return w, bias, x, h0, c0, ch, cc


def _fragment(w, bias, x, h0, c0, ch, cc, maxout: bool):
    """The lstm0 fragment through the blocked chain: hoisted x_contrib, the
    chain, the loss sum(hs * ch) + sum(cs * cc) and its backward. Returns
    (hs, cs, grads of w, bias, x, h0, c0)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb

    leaves = [t.detach().requires_grad_() for t in (w, bias, x, h0, c0)]
    lw, lbias, lx, lh0, lc0 = leaves
    t, b, d = lx.shape
    xc = (lx.reshape(t * b, d) @ lw[:d] + lbias).reshape(t, b, -1)
    hs, cs = lb.blocked_lstm_chain(xc, lh0, lc0, lw[d:], maxout=maxout)
    ((hs * ch).sum() + (cs * cc).sum()).backward()
    return hs.detach(), cs.detach(), [p.grad for p in leaves]


def _cell_route(w, bias, x, h0, c0, ch, cc, maxout: bool):
    """The same fragment as T `lstm_cell` launches with autograd."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels.lstm_cell import (
        lstm_cell)

    leaves = [t.detach().requires_grad_() for t in (w, bias, x, h0, c0)]
    lw, lbias, lx, lh0, lc0 = leaves
    h, c, hs, cs = lh0, lc0, [], []
    for t in range(lx.shape[0]):
        h, c = lstm_cell(lw, lbias, lx[t], h, c, maxout=maxout)
        hs.append(h)
        cs.append(c)
    hs, cs = torch.stack(hs), torch.stack(cs)
    ((hs * ch).sum() + (cs * cc).sum()).backward()
    return hs.detach(), cs.detach(), [p.grad for p in leaves]


def phase_chain_kernels(dev) -> dict:
    """B10's forward and backward kernels against their plain versions at
    the lstm0 fragment's shape (B 50, T 17, D 1024, H 512), G = 5 and G = 4,
    each direction twice bit for bit, and the whole fragment against T
    `lstm_cell` launches with autograd."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import build
    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
    from unpaired_image_captioning_tpu_torch.ops import lstm_block as lo

    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, d, h = CHAIN_SHAPE
    blocks = build.load().lstm_chain_blocks(h)
    rows = {"fwd": [], "bwd": []}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for maxout in (True, False):
        g = 5 if maxout else 4
        w, bias, x, h0, c0, ch, cc = _chain_inputs(dev, gen, g)
        xc = (x.reshape(t * b, d) @ w[:d] + bias).reshape(t, b, g * h)
        w_hh = w[d:].contiguous()
        f0, b0 = lb.fwd_launches, lb.bwd_launches
        hs, cs, gates = lb.chain_fwd(xc, h0, c0, w_hh, maxout=maxout)
        dg, dh0, dc0 = lb.chain_bwd(gates, cs, c0, ch, cc, w_hh,
                                    maxout=maxout)
        torch.cuda.synchronize()
        per_call = (lb.fwd_launches - f0, lb.bwd_launches - b0)
        phs, pcs, pgates = lo.chain_fwd_plain(xc, h0, c0, w_hh, maxout=maxout)
        pdg, pdh0, pdc0 = lo.chain_bwd_plain(pgates, pcs, c0, ch, cc, w_hh,
                                             maxout=maxout)
        hs_prev = torch.cat([h0[None], hs[:-1]]).reshape(-1, h)
        phs_prev = torch.cat([h0[None], phs[:-1]]).reshape(-1, h)
        dw = hs_prev.t() @ dg.reshape(-1, g * h)
        pdw = phs_prev.t() @ pdg.reshape(-1, g * h)
        tag = f"G={g}"
        e_f = _check_each(f"lstm_chain {tag} forward", ["hs", "cs", "gates"],
                          [hs, cs, gates], [phs, pcs, pgates], CHAIN_TOL)
        e_b = _check_each(f"lstm_chain {tag} backward",
                          ["dx_contrib", "dh0", "dc0", "dW_h2h"],
                          [dg, dh0, dc0, dw], [pdg, pdh0, pdc0, pdw],
                          CHAIN_TOL)
        # both directions sum in a fixed order: a rerun gives the same bits
        again = (lb.chain_fwd(xc, h0, c0, w_hh, maxout=maxout)
                 + lb.chain_bwd(gates, cs, c0, ch, cc, w_hh, maxout=maxout))
        if not all(torch.equal(a, c) for a, c in
                   zip(again, (hs, cs, gates, dg, dh0, dc0))):
            raise AssertionError(f"lstm_chain {tag}: two runs differ")
        # the whole fragment (autograd Function, hoisted matmuls) against
        # the per-step route: 17 lstm_cell launches with autograd
        inputs = (w, bias, x, h0, c0, ch, cc)
        fr = _fragment(*inputs, maxout=maxout)
        cr = _cell_route(*inputs, maxout=maxout)
        e_c = _check_each(f"lstm_chain {tag} vs lstm_cell steps",
                          ["hs", "cs", "dw", "db", "dx", "dh0", "dc0"],
                          fr[:2] + tuple(fr[2]), cr[:2] + tuple(cr[2]),
                          CHAIN_TOL)
        worst["fwd"] = max(worst["fwd"], e_f)
        worst["bwd"] = max(worst["bwd"], e_b)
        shape = f"G={g} [T {t}, B {b}, H {h}]"
        kf, pf, kfw, pfw, how_f = time_pair(
            lambda: lb.chain_fwd(xc, h0, c0, w_hh, maxout=maxout),
            lambda: lo.chain_fwd_plain(xc, h0, c0, w_hh, maxout=maxout),
            "chain_fwd_kernel")
        kb, pb, kbw, pbw, how_b = time_pair(
            lambda: lb.chain_bwd(gates, cs, c0, ch, cc, w_hh, maxout=maxout),
            lambda: lo.chain_bwd_plain(gates, cs, c0, ch, cc, w_hh,
                                       maxout=maxout),
            "chain_bwd_kernel")
        mm = 2.0 * t * b * h * g * h           # h @ W (or dgates @ W^T) per step
        bf_ms, bf_by = bound(nbytes(xc, h0, c0, w_hh, hs, cs, gates), mm)
        bb_ms, bb_by = bound(nbytes(gates, cs, c0, ch, cc, w_hh, dg, dh0,
                                    dc0), mm)
        lib_ms, lib_msg = None, "none (maxout)"
        lib_bwd, lib_bwd_msg = None, "none (maxout)"
        if g == 4:
            # cuDNN's LSTM over the same T steps, gate blocks permuted from
            # (i, f, o, g) to (i, f, g, o); it also computes x @ W_ih
            cols = torch.cat([torch.arange(j * h, (j + 1) * h, device=dev)
                              for j in (0, 1, 3, 2)])
            lstm = torch.nn.LSTM(d, h).to(dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(w[:d, cols].t())
                lstm.weight_hh_l0.copy_(w[d:, cols].t())
                lstm.bias_ih_l0.copy_(bias[cols])
                lstm.bias_hh_l0.zero_()
                lhs, _ = lstm(x, (h0[None], c0[None]))
                lib_err = (lhs - phs).abs().max().item()
                lib_ms, lib_how = library_ms(
                    lambda: lstm(x, (h0[None], c0[None])))
            lib_msg = (f"cuDNN torch.nn.LSTM over {t} steps, x @ W_ih "
                       f"included, {lib_ms:.4f} ms ({lib_how}; max|diff| hs "
                       f"vs plain {lib_err:.3g})")
            # its backward over the same steps, for the same upstream dhs
            # (it also computes dx and dW_ih, which the chain leaves out)
            lx = x.detach().requires_grad_()
            lh0, lc0 = (z[None].detach().requires_grad_() for z in (h0, c0))
            lout, _ = lstm(lx, (lh0, lc0))
            lib_bwd, lib_how = library_ms(lambda: torch.autograd.grad(
                lout, (lx, lh0, lc0, *lstm.parameters()), ch,
                retain_graph=True))
            lib_bwd_msg = (f"cuDNN torch.nn.LSTM backward over {t} steps "
                           f"(dx and dW_ih too) {lib_bwd:.4f} ms ({lib_how})")
        rows["fwd"].append(dict(label="lstm0 fragment", ms=kf,
                                plain_ms=pf, bound_ms=bf_ms, bound_by=bf_by,
                                library_ms=lib_ms, timing=how_f, shape=shape))
        rows["bwd"].append(dict(label="lstm0 fragment", ms=kb,
                                plain_ms=pb, bound_ms=bb_ms, bound_by=bb_by,
                                library_ms=lib_bwd, timing=how_b,
                                shape=shape))
        log(f"kernel lstm_chain {shape}: {blocks} blocks, launches per chain "
            f"call fwd {per_call[0]} + bwd {per_call[1]}; max|diff| / max(1, "
            f"max|plain|) forward {e_f:.3g}, backward (dx_contrib, dh0, dc0, "
            f"dW_h2h) {e_b:.3g}, fragment vs {t} lstm_cell steps {e_c:.3g} "
            f"(tol {CHAIN_TOL}); forward and backward twice: identical bits; "
            f"{how_f}: forward kernel {kf:.4f} ms, plain "
            f"{pf:.4f} ms (per call {kfw:.4f} / {pfw:.4f}), bound "
            f"{bf_ms:.4f} ms ({bf_by}); backward kernel {kb:.4f} ms, plain "
            f"{pb:.4f} ms (per call {kbw:.4f} / {pbw:.4f}), bound "
            f"{bb_ms:.4f} ms ({bb_by}); library: {lib_msg}; {lib_bwd_msg}")
    rec = {}
    for key, line in (("fwd", "52"), ("bwd", "120")):
        main = rows[key][0]
        rec[f"lstm_chain_{key}"] = {
            "name": f"lstm_chain_{key}", "route": "cuda",
            "source": "unpaired_image_captioning_tpu_torch/csrc/lstm_block.cu",
            "replaces": f"unpaired_image_captioning_tpu/ops/lstm_block.py:{line}",
            "max_abs_err": worst[key], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": f"{main['label']}: {main['shape']}",
            "timing": main["timing"], "shapes": rows[key]}
    return rec


def phase_chain_path(dev) -> dict:
    """B10's path: the lstm0 fragment (maxout) through `blocked_lstm_chain`,
    forward and backward once, with the launch counts set to 0 just before
    and read just after."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb

    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = _chain_inputs(dev, gen, 5)
    lb.fwd_launches = lb.bwd_launches = 0
    t0 = time.perf_counter()
    hs, cs, grads = _fragment(*inputs, maxout=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"lstm_chain_fwd": lb.fwd_launches,
              "lstm_chain_bwd": lb.bwd_launches}
    if not all(torch.isfinite(g).all() for g in grads + [hs, cs]):
        raise AssertionError("lstm0 fragment: non-finite output or gradient")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"the lstm0 fragment never launched {name}")
    log(f"lstm0 fragment (B 50, T 17, D 1024, H 512, maxout): forward + "
        f"backward {wall * 1e3:.1f} ms wall; launches " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
    return counts


def make_torchvision_resnet(depth: str, seed: int) -> dict:
    """A torchvision-layout ResNet state dict of random numbers from `seed`:
    He-scaled convolutions, BatchNorm statistics near the identity."""
    from unpaired_image_captioning_tpu_torch.models.resnet import BLOCKS

    rng = np.random.default_rng(seed)
    state = {}

    def normal(shape, std):
        return rng.standard_normal(shape, np.float32) * np.float32(std)

    def conv(name, cout, cin, k):
        state[name] = normal((cout, cin, k, k), np.sqrt(2.0 / (cin * k * k)))

    def bn(name, c):
        state[name + ".weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        state[name + ".bias"] = normal((c,), 0.05)
        state[name + ".running_mean"] = normal((c,), 0.05)
        state[name + ".running_var"] = rng.uniform(0.8, 1.2, c).astype(
            np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, n_blocks in enumerate(BLOCKS[depth]):
        planes = 64 * 2 ** li
        for b in range(n_blocks):
            pre = f"layer{li + 1}.{b}"
            conv(pre + ".conv1.weight", planes, cin, 1)
            bn(pre + ".bn1", planes)
            conv(pre + ".conv2.weight", planes, planes, 3)
            bn(pre + ".bn2", planes)
            conv(pre + ".conv3.weight", planes * 4, planes, 1)
            bn(pre + ".bn3", planes * 4)
            if b == 0:
                conv(pre + ".downsample.0.weight", planes * 4, cin, 1)
                bn(pre + ".downsample.1", planes * 4)
            cin = planes * 4
    return state


def make_image_folder(root: str, n: int) -> list:
    """n seeded uint8 .npy images, alternating RAW_SHAPES; their paths."""
    import os

    rs = np.random.RandomState(0)
    paths = []
    for i in range(n):
        h, w = RAW_SHAPES[i % len(RAW_SHAPES)]
        path = os.path.join(root, f"img{i:03d}.npy")
        np.save(path, rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        paths.append(path)
    return paths


def _is_conv(name: str) -> bool:
    return any(k in name.lower() for k in CONV_KERNEL_WORDS)


def phase_raw_images(dev, cap, nmt, tgt_itos, cap2nmt, resnet_state) -> int:
    """The raw-image path: RawImageLoader (host read and nearest resize,
    uint8 upload, B11, ResNet-101) -> the LSTM pivot, then prepro_feats on
    four images. Returns B11's launches in the loader's timed batches."""
    import json as _json
    import os
    import tempfile

    import torch

    from unpaired_image_captioning_tpu_torch.data.raw_images import (
        RawImageLoader)
    from unpaired_image_captioning_tpu_torch.kernels import image as ik
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.pivot import pivot_translate
    from unpaired_image_captioning_tpu_torch.scripts import prepro_feats

    with tempfile.TemporaryDirectory() as root:
        folder = os.path.join(root, "images")
        os.makedirs(folder)
        paths = make_image_folder(folder, RAW_BATCH)
        loader = RawImageLoader(folder_path=folder, batch_size=RAW_BATCH,
                                att_size=ATT_SIZE, depth="resnet101",
                                image_size=IMG_SIZE,
                                resnet_params=resnet_state, device=dev)
        loader.get_batch()        # first use of every op (cuDNN plans)
        torch.cuda.synchronize()
        ik.launches = 0
        walls = []
        for _ in range(RAW_TIMED):
            t0 = time.perf_counter()
            batch = loader.get_batch()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = ik.launches
        if launches <= 0:
            raise AssertionError("the raw-image path never launched "
                                 "image_front_end")
        fc, att = batch["fc_feats"], batch["att_feats"]
        if (tuple(fc.shape) != (RAW_BATCH, 2048)
                or tuple(att.shape) != (RAW_BATCH, ATT_SIZE ** 2, 2048)
                or not (torch.isfinite(fc).all() and torch.isfinite(att).all())):
            raise AssertionError(f"raw-image features: fc {tuple(fc.shape)}, "
                                 f"att {tuple(att.shape)} or not finite")
        wall = statistics.mean(walls)
        busy, per_name = device_ms(loader.get_batch)
        msg = "device busy not measured (no profiler data)"
        if busy is not None:
            b11 = [(us, k) for n, (us, k) in per_name.items()
                   if "front_end_kernel" in n]
            b11_ms = sum(us for us, _ in b11) / 1e3
            conv = sum(us for n, (us, _) in per_name.items()
                       if _is_conv(n)) / 1e3
            msg = (f"device busy {busy:.1f} ms, idle share "
                   f"{1 - busy / (wall * 1e3):.2f}; of the busy time B11 "
                   f"{b11_ms:.4f} ms in {sum(k for _, k in b11)} launches "
                   f"({b11_ms / busy:.5f}), convolutions {conv:.1f} ms "
                   f"({conv / busy:.2f})")
        log(f"raw images: get_batch of {RAW_BATCH} images "
            f"({' and '.join(f'{h}x{w}' for h, w in RAW_SHAPES)} -> "
            f"{IMG_SIZE}, ResNet-101): {wall * 1e3:.1f} ms mean of "
            f"{RAW_TIMED} ({', '.join(f'{x * 1e3:.1f}' for x in walls)}), "
            f"{RAW_BATCH / wall:.1f} images/s; {msg}; image_front_end "
            f"launches {launches}")
        top = sorted((per_name or {}).items(), key=lambda kv: -kv[1][0])
        for name, (us, n) in top[:TOP_OPS]:
            log(f"raw images: device op {us / 1e3:8.3f} ms {n:6d}x  "
                f"{name[:90]}")

        feats = Features(fc_feats=fc, att_feats=att,
                         att_masks=batch["att_masks"])
        t0 = time.perf_counter()
        zh, en, _ = pivot_translate(cap, nmt, feats,
                                    torch.as_tensor(cap2nmt, device=dev),
                                    cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                                    nmt_max_len=NMT_MAX_LEN)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if tuple(en.shape) != (RAW_BATCH, NMT_MAX_LEN) or not (
                int(en.min()) >= 0 and int(en.max()) < NMT["tgt_vocab_size"]):
            raise AssertionError(f"raw-image pivot: en {tuple(en.shape)} or "
                                 "ids out of range")
        words = [tgt_itos[i] for i in en[0].tolist()]
        log(f"raw images: pivot_translate (caption beam {CAP_BEAM} -> NMT "
            f"beam {NMT_BEAM}) of the {RAW_BATCH} images {secs * 1e3:.1f} "
            f"ms; image 0 ({os.path.basename(batch['infos'][0]['file_path'])}"
            f") en tokens: {' '.join(words)}")

        listing = os.path.join(root, "images.json")
        with open(listing, "w") as f:
            _json.dump({"images": [{"id": 100 + i, "file_path": p}
                                   for i, p in enumerate(paths[:4])]}, f)
        out = os.path.join(root, "feats")
        prepro_feats.main(["--input_json", listing, "--output_dir", out,
                           "--batch_size", "4"])
        for i in range(4):
            fc_i = np.load(os.path.join(out + "_fc", f"{100 + i}.npy"))
            att_i = np.load(os.path.join(out + "_att",
                                         f"{100 + i}.npz"))["feat"]
            if (fc_i.shape != (2048,) or att_i.shape != (ATT_SIZE, ATT_SIZE,
                                                         2048)
                    or not (np.isfinite(fc_i).all()
                            and np.isfinite(att_i).all())):
                raise AssertionError(f"prepro_feats image {100 + i}: fc "
                                     f"{fc_i.shape}, att {att_i.shape}")
        log("raw images: prepro_feats wrote 4 fc [2048] .npy and att "
            f"[{ATT_SIZE}, {ATT_SIZE}, 2048] .npz files")
    return launches


def phase_resnet_agreement(dev, resnet_state) -> None:
    """ResNet-101 on two images at 448, the same converted weights on the
    card and on the CPU: fc and att within AGREE_TOL * max(1, max|cpu|)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import image as ik
    from unpaired_image_captioning_tpu_torch.models.resnet import ResNet

    imgs = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, IMG_SIZE, IMG_SIZE, 3)).astype(np.uint8))
    x = ik.resize_normalize(imgs, h_out=IMG_SIZE, w_out=IMG_SIZE)
    res = {}
    for where in ("cpu", dev):
        net = ResNet("resnet101", device=where)
        net.load_state_dict(resnet_state)
        with torch.no_grad():
            fc, att = net.my_resnet(x.to(where), att_size=ATT_SIZE)
        res[str(where)] = (fc.cpu(), att.cpu())
    (cfc, catt), (gfc, gatt) = res["cpu"], res[str(dev)]
    errs = []
    for name, g, c in (("fc", gfc, cfc), ("att", gatt, catt)):
        err = (g - c).abs().max().item() / max(1.0, c.abs().max().item())
        if not err <= AGREE_TOL:
            raise AssertionError(f"ResNet-101 card vs cpu: {name} max|diff| "
                                 f"/ max(1, max|cpu|) {err} > {AGREE_TOL}")
        errs.append(f"{name} {err:.3g} (max|cpu| {c.abs().max().item():.4g})")
    log("resnet agreement: ResNet-101 at 448 on 2 images, card vs cpu, "
        "max|diff| / max(1, max|cpu|): " + ", ".join(errs))


# the training CLI's recipe at full width (train.sh:18-29: XE, then SCST
# resumed with --start_from): denseatt at CAP's widths jointly with the
# BiLSTM NMT at NMT's vocabularies under Weight_Trans, on synthetic
# artifacts written by the port's data/synthetic.py
RECIPE_SPLITS = (100, 50, 10)     # train, val, test images, 5 captions each
RECIPE_PAIRS, RECIPE_VALID_PAIRS = 2000, 100
RECIPE_ARGS = dict(
    caption_model="denseatt", rnn_size=CAP["rnn_size"],
    input_encoding_size=CAP["input_encoding_size"],
    att_hid_size=CAP["att_hid_size"], num_layers=CAP["num_layers"],
    fc_feat_size=CAP["fc_feat_size"], att_feat_size=CAP["att_feat_size"],
    word_vec_size=NMT["word_vec_size"], layers=NMT["layers"],
    i2t_train_flag="true", nmt_train_flag="true", batch_size=50,
    seq_per_img=5, self_critical_after=3, max_epochs=4,
    save_checkpoint_every=4, language_eval=1, beam_size=3,
    losses_log_every=1, load_best_score=0, val_images_use=50, seed=0,
    dtype="float32")
# the transformer captioner through the same CLI: TCAP's widths, XE only,
# one eval at beam 3 (steps 1-2 of epoch 0 and the step that wraps it)
RECIPE_TRANSFORMER = dict(
    RECIPE_ARGS, caption_model="transformer", num_layers=TCAP["num_layers"],
    num_heads=TCAP["num_heads"], nmt_train_flag="false",
    self_critical_after=-1, max_epochs=1, save_checkpoint_every=2)
# the kernels the recipe runs, by counter: (module, attribute)
RECIPE_KERNELS = ("lstm_cell", "row_topk")
RECIPE_TRANSFORMER_KERNELS = (
    "transformer_decode_stack", "mha_train_fwd", "mha_train_bwd",
    "enc_layer_train_fwd", "enc_layer_train_bwd", "ln_train_fwd",
    "ln_train_bwd")


def make_recipe_artifacts(root: str) -> dict:
    """The recipe's files under `root`: talk.json and label.npz (CAP's
    vocabulary, 16-token captions), one fc and one att (196 x 2,048)
    `.npy` per image, the NMT corpus (train and valid `.npz`) at NMT's
    vocabularies, the NMT dicts (the source dict holds every caption word,
    so Weight_Trans aligns all 9,487 rows) and the df cache of the port's
    prepro_ngrams."""
    import os

    from unpaired_image_captioning_tpu_torch import constants as C
    from unpaired_image_captioning_tpu_torch.data import synthetic
    from unpaired_image_captioning_tpu_torch.scripts import prepro_ngrams
    from unpaired_image_captioning_tpu_torch.vocab import Dict

    n_train, n_val, n_test = RECIPE_SPLITS
    jpath, label, mem = synthetic.make_caption_artifacts(
        root, n_images=n_train + n_val + n_test,
        vocab_size=CAP["vocab_size"], seq_length=CAP["seq_length"],
        caps_per_img=5, fc_dim=CAP["fc_feat_size"],
        att_dim=CAP["att_feat_size"], att_len=N_SLOTS, seed=0,
        n_val=n_val, n_test=n_test)
    fc_dir, att_dir = synthetic.write_feature_dirs(root, mem)
    del mem
    src, tgt = synthetic.make_nmt_corpus(
        n_pairs=RECIPE_PAIRS + RECIPE_VALID_PAIRS,
        src_vocab=NMT["src_vocab_size"], tgt_vocab=NMT["tgt_vocab_size"],
        src_len=NMT_SRC_LEN, tgt_len=NMT_TGT_LEN, seed=1)
    nmt = {}
    for split, rows in (("train", slice(0, RECIPE_PAIRS)),
                        ("valid", slice(RECIPE_PAIRS, None))):
        nmt[split] = os.path.join(root, f"nmt.{split}.npz")
        np.savez(nmt[split], src=src[rows], tgt=tgt[rows])
    specials = [C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
    dicts = {"src": Dict(specials + [f"w{i}" for i in range(
                 NMT["src_vocab_size"] - 4)]).state_dict(),
             "tgt": Dict(specials + [f"t{i}" for i in range(
                 NMT["tgt_vocab_size"] - 4)]).state_dict()}
    dict_path = os.path.join(root, "dicts.json")
    with open(dict_path, "w") as f:
        json.dump(dicts, f)
    ngrams = os.path.join(root, "ngrams.npz")
    with _quiet():
        prepro_ngrams.main(["--input_label_h5", label, "--input_json", jpath,
                            "--output", ngrams])
    return dict(input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
                input_att_dir=att_dir, input_nmt_h5=nmt["train"],
                input_nmt_dict=dict_path, cached_tokens=ngrams)


class _quiet:
    """Keeps what a CLI prints, for the log of a failure."""

    def __enter__(self):
        import contextlib
        import io

        self.out = io.StringIO()
        self._cm = contextlib.redirect_stdout(self.out)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)
        if exc[0] is not None:
            sys.stderr.write(self.out.getvalue()[-8000:])
        return False


def _recipe_run(files: dict, run: str, **kw):
    """One `cli.train.main` on the card; returns (trainer, wall s, its
    events)."""
    import os

    import torch

    from unpaired_image_captioning_tpu_torch.cli import train as cli

    args = dict(RECIPE_ARGS, **files, checkpoint_path=run,
                id=os.path.basename(run))
    args.update(kw)
    argv = []
    for k, v in args.items():
        argv += ["--" + k, str(v)]
    t0 = time.perf_counter()
    with _quiet():
        trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return trainer, wall, events


def _state_tensors(trainer) -> list:
    """(name, tensor) of both models' parameters and the optimizer's
    moments and counts, in a fixed order."""
    out = []
    for tag, model in (("i2t", trainer.i2t_model), ("nmt", trainer.nmt_model)):
        if model is not None:
            out += [(f"{tag}.{k}", v) for k, v in model.state_dict().items()]
    st = trainer.optim.state_dict()
    for side in ("i2t_state", "nmt_state"):
        for i, part in enumerate(st[side] or []):
            for field, v in part.items():
                items = v.items() if isinstance(v, dict) else [("", v)]
                out += [(f"optim.{side}.{i}.{field}.{k}", x)
                        for k, x in items]
    return out


def _same_state(a, b, label: str) -> None:
    import torch

    sa, sb = _state_tensors(a), _state_tensors(b)
    if [k for k, _ in sa] != [k for k, _ in sb]:
        raise AssertionError(f"{label}: the two runs hold other states")
    for (k, x), (_, y) in zip(sa, sb):
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
        if not same:
            raise AssertionError(f"{label}: {k} differs between the full "
                                 "run and the resumed run")


def _steps(events) -> list:
    return [e for e in events if "total_loss" in e]


def phase_recipe(dev) -> dict:
    """`python -m unpaired_image_captioning_tpu_torch.cli.train` on the
    card at full width: the joint denseatt + BiLSTM NMT recipe (7 XE steps,
    then 2 SCST steps from epoch 3, eval with language_eval at beam 3 and a
    checkpoint every 4 steps), the same stopped at epoch 3 and resumed with
    --start_from (bit for bit the full run's parameters and optimizer
    state), and the transformer captioner (3 XE steps, an eval at beam 3).
    Then `phase_eval_clis` in the same directory, on these run dirs.
    Returns the launches of each kernel in the recipe, and in the eval
    CLIs."""
    import os
    import tempfile

    import torch

    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    counters = {"lstm_cell": (lk, "launches"), "row_topk": (tk, "launches"),
                "transformer_decode_stack": (tdk, "stack_launches"),
                "mha_train_fwd": (mhk, "fwd_launches"),
                "mha_train_bwd": (mhk, "bwd_launches"),
                "enc_layer_train_fwd": (ltk, "enc_fwd_launches"),
                "enc_layer_train_bwd": (ltk, "enc_bwd_launches"),
                "ln_train_fwd": (lnk, "fwd_launches"),
                "ln_train_bwd": (lnk, "bwd_launches")}
    t_phase = time.perf_counter()
    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="recipe-") as root:
        # language_eval writes its eval_results/ under the working directory
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            files = make_recipe_artifacts(root)
            log(f"recipe artifacts: {sum(RECIPE_SPLITS)} images, "
                f"{RECIPE_PAIRS} + {RECIPE_VALID_PAIRS} NMT pairs, df cache "
                f"({time.perf_counter() - t0:.1f} s, host)")
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            full, wall_full, ev = _recipe_run(files, os.path.join(root,
                                                                  "full"))
            half_run = os.path.join(root, "half")
            _, wall_half, _ = _recipe_run(files, half_run, max_epochs=3)
            resumed, wall_res, ev_res = _recipe_run(
                files, half_run, start_from=half_run)
            counts = {k: getattr(*counters[k]) for k in RECIPE_KERNELS}
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            tcap, wall_t, ev_t = _recipe_run(
                files, os.path.join(root, "transformer"),
                **RECIPE_TRANSFORMER)
            tcounts = {k: getattr(*counters[k])
                       for k in RECIPE_TRANSFORMER_KERNELS + ("row_topk",)}
            _check_recipe(ev, ev_res, full, resumed, os.path.join(root,
                                                                  "full"))
            _check_transformer_recipe(ev_t, tcap)
            _log_recipe(ev, ev_res, ev_t, os.path.join(root, "full"), full,
                        (wall_full, wall_half, wall_res, wall_t))
            for name, n in list(counts.items()) + list(tcounts.items()):
                if not n:
                    raise AssertionError(f"recipe: {name} was not launched")
            log(f"recipe phase: {time.perf_counter() - t_phase:.1f} s")
            del resumed, tcap
            torch.cuda.empty_cache()
            eval_counts = phase_eval_clis(dev, root, files, full, wall_full)
        finally:
            os.chdir(here)
    counts["row_topk"] += tcounts.pop("row_topk")
    counts.update(tcounts)
    log(f"recipe launches: {json.dumps(counts)}")
    del full
    torch.cuda.empty_cache()
    return counts, eval_counts


def _check_recipe(ev, ev_res, full, resumed, run) -> None:
    import os

    steps = _steps(ev)
    if [e["step"] for e in steps] != list(range(1, 10)):
        raise AssertionError(f"recipe: steps {[e['step'] for e in steps]}")
    rl = [e["step"] for e in steps if "avg_reward" in e]
    # SCST from the step that starts epoch self_critical_after (3) on
    first = next(e["step"] for e in steps
                 if e["epoch"] >= RECIPE_ARGS["self_critical_after"]) + 1
    if rl != list(range(first, 10)) or first != 8:
        raise AssertionError(f"recipe: avg_reward at steps {rl}, the switch "
                             f"at step {first}")
    if not all(np.isfinite(e["total_loss"]) and np.isfinite(
            e.get("avg_reward", 0.0)) for e in steps):
        raise AssertionError("recipe: a non-finite loss or reward")
    with open(os.path.join(run, "histories.json")) as f:
        vals = json.load(f)["val_result_history"]
    if sorted(vals, key=int) != ["4", "8"]:
        raise AssertionError(f"recipe: evals at {sorted(vals)}")
    for it, val in vals.items():
        stats = list(val["lang_stats"].values()) + [
            val["loss"], *val["nmt_stats"].values()]
        if not all(np.isfinite(stats)):
            raise AssertionError(f"recipe: eval at {it} not finite: {val}")
    for name in ("model_i2t", "model_nmt", "optimizer"):
        for best in ("", "-best"):
            if not os.path.exists(os.path.join(run, f"{name}{best}.pt")):
                raise AssertionError(f"recipe: no {name}{best}.pt")
    if resumed.iteration != full.iteration:
        raise AssertionError("recipe: the resumed run ends at iter "
                             f"{resumed.iteration}, the full run at "
                             f"{full.iteration}")
    # the stopped run and its resumption append to one events.jsonl
    if [e["total_loss"] for e in _steps(ev_res)] != [
            e["total_loss"] for e in steps]:
        raise AssertionError("recipe: the resumed run's losses differ")
    _same_state(full, resumed, "recipe resume")


def _check_transformer_recipe(ev_t, tcap) -> None:
    steps = _steps(ev_t)
    if len(steps) != 3 or any("avg_reward" in e for e in steps):
        raise AssertionError(f"transformer recipe: {len(steps)} steps")
    vals = [e for e in ev_t if "val_loss" in e]
    if len(vals) != 1 or not np.isfinite(vals[0]["val_loss"]):
        raise AssertionError(f"transformer recipe: evals {vals}")
    if tcap.best_cider is None or not np.isfinite(tcap.best_cider):
        raise AssertionError("transformer recipe: no finite val CIDEr")


def _log_recipe(ev, ev_res, ev_t, run, full, walls) -> None:
    import os

    import torch

    steps = _steps(ev)
    # step 1 builds the models' first graphs: the walls are of steps 2-7
    xe = [e["step_time"] for e in steps[1:7]]
    rl = [e["step_time"] for e in steps[7:]]
    tx = [e["step_time"] for e in _steps(ev_t)[1:]]
    log("recipe step wall through the CLI (joint denseatt + BiLSTM NMT, "
        f"batch 50 x 5 captions): XE {statistics.mean(xe) * 1e3:.1f} ms "
        f"(steps 2-7: {', '.join(f'{t * 1e3:.1f}' for t in xe)}), SCST "
        f"{statistics.mean(rl) * 1e3:.1f} ms (steps 8-9: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in rl)}); transformer XE "
        f"{statistics.mean(tx) * 1e3:.1f} ms (steps 2-3)")
    evals = [e["eval_time"] for e in ev + ev_t if "eval_time" in e]
    log("recipe eval wall over the 50 val images (XE loss of 250 captions, "
        "beam 3, language_eval; denseatt also the NMT valid set): denseatt "
        f"{', '.join(f'{t:.2f}' for t in evals[:-1])} s, transformer "
        f"{evals[-1]:.2f} s")
    sizes = {n: os.path.getsize(os.path.join(run, f"{n}.pt"))
             for n in ("model_i2t", "model_nmt", "optimizer")}
    saves = [e["save_time"] for e in ev + ev_res if "save_time" in e]
    t0 = time.perf_counter()
    full.load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"recipe checkpoint: {sum(sizes.values()) / 1e6:.1f} MB ("
        + ", ".join(f"{n} {v / 1e6:.1f}" for n, v in sizes.items())
        + f"); write (with -best where the eval was best) "
        f"{', '.join(f'{t:.2f}' for t in saves)} s; load {load_s:.2f} s")
    log(f"recipe CLI walls: full {walls[0]:.1f} s, stopped at epoch 3 "
        f"{walls[1]:.1f} s, resumed {walls[2]:.1f} s, transformer "
        f"{walls[3]:.1f} s")


# the eval CLIs on the recipe's run dirs: the kernels each one launches, by
# counter (module, attribute), and the test split the evals read in one
# batch (the recipe's 10 test images), so that the fused and the staged
# pivot give their NMT the same batch
EVAL_KERNELS = ("lstm_cell", "row_topk", "transformer_decode_stack",
                "image_front_end")
EVAL_BATCH = RECIPE_SPLITS[2]
EVAL_RAW_IMAGES = 4
MIGRATE_SCALE = 0.04   # the generated reference weights: normal * this


def _eval_counters() -> dict:
    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    return {"lstm_cell": (lk, "launches"), "row_topk": (tk, "launches"),
            "transformer_decode_stack": (tdk, "stack_launches"),
            "image_front_end": (imk, "launches")}


def _eval_argv(files: dict, run: str, **kw) -> list:
    args = dict(start_from=run, input_json=files["input_json"],
                input_label_h5=files["input_label_h5"],
                input_fc_dir=files["input_fc_dir"],
                input_att_dir=files["input_att_dir"], batch_size=EVAL_BATCH,
                beam_size=CAP_BEAM, id="eval")
    args.update(kw)
    return [x for k, v in args.items() for x in ("--" + k, str(v))]


def _held_eval_shapes() -> dict:
    """The shapes at which the kernel checks hold B1, B2, B4 and B11
    against their plain versions, keyed as `_recording_shapes` keys a
    call: B1 (B, D, H, maxout), B2 (R, V, k), B4 (B, beams, L, T, S, d,
    d_ff, heads, lazy), B11 (B, H, W, out)."""
    return {"lstm_cell": {s[1:] for s in LSTM_SHAPES},
            "row_topk": {s[1:] for s in TOPK_SHAPES},
            "transformer_decode_stack": {s[1:] for s in TFD_SHAPES},
            "image_front_end": {s[1:] for s in IMG_CASES}}


def _unheld(dev, name: str, seen: set, held: set) -> set:
    """The keys of `seen` that no kernel check holds: f32 ones must be in
    `held`; a B1 key with a bf16 mixture (B, D, H, maxout, types) is held
    here, against the plain cell at its shape and types at BF16_TOL
    (`_hold_bf16`)."""
    if name == "transformer_decode_stack":
        bf = {k for k in seen if len(k) == 10}
        for key in sorted(bf, key=str):
            _hold_tfd_key(dev, key)
        if bf:
            log(f"transformer_decode_stack bf16 mixtures held against the "
                f"plain step: {sorted(bf, key=str)}")
        return (seen - bf) - held
    if name != "lstm_cell":
        return seen - held
    bf = {k for k in seen if len(k) == 5}
    if bf:
        _hold_bf16(dev, {"lstm_cell": bf}, {"lstm_cell": set()})
        log(f"lstm_cell bf16 mixtures held against the plain cell: "
            f"{sorted(bf, key=str)}")
    return (seen - bf) - held


def _hold_tfd_key(dev, key) -> float:
    """B4's stack against its plain version at a (shape, mixture) key of
    `_recording_shapes`, on seeded inputs in that mixture, at BF16_TOL."""
    import torch

    bsz, kb, n_l, n_t, slots, d, dff, heads, lazy, mix = key
    a = _tfd_inputs(dev, torch.Generator(device=dev).manual_seed(33), bsz,
                    kb, n_l, n_t, slots, d, dff, lazy is True)
    tx, tw, tc, tm = (_dt(m) for m in mix)
    args = (a["x"].to(tx), a["t"], a["ck"].to(tm), a["cv"].to(tm),
            a["mask"], a["kc"].to(tc), a["vc"].to(tc),
            {k: v.to(tw) for k, v in a["w"].items()}, a["anc"])
    return _tf_check("decoder_stack_step", args,
                     dict(n_heads=heads, want_attn=lazy is True), True)


class _recording_shapes:
    """While open, every call the eval path makes to B1, B2, B4 and B11
    adds its shape to `shapes[name]`, keyed as `_held_eval_shapes`: the
    wrappers are wrapped where the port's modules call them (the top-k at
    the beam search's call, which routes every k <= 16 to B2)."""

    def __init__(self, shapes: dict):
        from unpaired_image_captioning_tpu_torch.data import raw_images
        from unpaired_image_captioning_tpu_torch.models import (
            nmt_transformer, transformer)
        from unpaired_image_captioning_tpu_torch.ops import beam_search, rnn

        def lstm(a, kw):
            w, x, h = a[0], a[2], a[3]
            key = (x.shape[0], x.shape[1], h.shape[1], kw["maxout"])
            # the card's serving and eval round the features to bf16: such
            # a call's key carries its (x, w, h) types (`_unheld`)
            mix = tuple(_mix_name([t.dtype]) for t in (x, w, h))
            return key if mix == ("f32",) * 3 else key + (mix,)

        def topk(a, kw):
            return (a[0].shape[0], a[0].shape[1], a[1])

        def tfd(a, kw):
            x, ck_all, cache_k, wstack = a[0], a[2], a[5], a[7]
            anc = a[8] if len(a) > 8 else kw.get("anc")
            n_l, bsz, slots, d = ck_all.shape
            # the checks run the lazy ancestry and the attention output
            # together or neither
            lazy = (anc is not None if (anc is not None)
                    == kw.get("want_attn", False) else None)
            key = (bsz, x.shape[0] // bsz, n_l, cache_k.shape[2], slots, d,
                   wstack["w1"].shape[2], kw["n_heads"], lazy)
            # the card's serving and eval round the features: the memory
            # and the caches are bf16 (x, weights, caches, memory)
            mix = _tf_mix(x, wstack["wqkv"], cache_k, ck_all)
            return key if mix == ("f32",) * 4 else key + (mix,)

        def img(a, kw):
            b, h, w, c = a[0].shape
            out = kw.get("h_out", 448)
            return (b, h, w, out if (c, kw.get("w_out", 448)) == (3, out)
                    else None)

        self._sites = [(rnn, "lstm_cell", "lstm_cell", lstm),
                       (beam_search, "row_topk", "row_topk", topk),
                       (transformer, "decoder_stack_step",
                        "transformer_decode_stack", tfd),
                       (nmt_transformer, "decoder_stack_step",
                        "transformer_decode_stack", tfd),
                       (raw_images, "resize_normalize", "image_front_end",
                        img)]
        self._shapes = shapes

    def __enter__(self):
        self._saved = []
        for mod, attr, name, key in self._sites:
            fn = getattr(mod, attr)

            def call(*a, _fn=fn, _name=name, _key=key, **kw):
                self._shapes.setdefault(_name, set()).add(_key(a, kw))
                return _fn(*a, **kw)

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, call)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


class _bf16_features:
    """While open, every `CaptionDataLoader` is built with
    `feat_dtype="bfloat16"`: its features come out rounded to bf16."""

    def __enter__(self):
        from unpaired_image_captioning_tpu_torch.data import dataloader as dl

        self._cls, self._init = dl.CaptionDataLoader, (
            dl.CaptionDataLoader.__init__)

        def init(obj, *a, **kw):
            self._init(obj, *a, **dict(kw, feat_dtype="bfloat16"))

        self._cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self._cls.__init__ = self._init


def _run_cli(label: str, main, argv, totals: dict, runs: list,
             shapes: dict):
    """One CLI on the card with the eval kernels' counts set to 0 just
    before and read just after, and the shapes it gives them recorded;
    logs its wall and launches."""
    import torch

    counters = _eval_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with _quiet(), _recording_shapes(shapes):
        out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: getattr(*counters[k]) for k in EVAL_KERNELS}
    for k, n in counts.items():
        totals[k] += n
    runs.append((label, wall, counts))
    log(f"eval CLI {label}: {wall:.2f} s, launches {json.dumps(counts)}")
    return out


def _refs_json(root: str, files: dict) -> str:
    """English references for the recipe's test images, 5 each, made of
    the NMT target dict's words."""
    import os

    with open(files["input_json"]) as f:
        ids = [im["id"] for im in json.load(f)["images"]
               if im["split"] == "test"]
    rs = np.random.RandomState(2)
    refs = {str(i): [" ".join(f"t{j}" for j in rs.randint(0, 500, 9))
                     for _ in range(5)] for i in ids}
    path = os.path.join(root, "coco_refs.json")
    with open(path, "w") as f:
        json.dump(refs, f)
    return path


def make_reference_pair(root: str, files: dict) -> dict:
    """A reference run's artifacts at the recipe's widths, from random
    tensors (seed 0): denseatt and BiLSTM NMT `.pth` state dicts in the
    reference's layout (torch's Linear / LSTM shapes and (i, f, g, o) gate
    order), a py2-style infos.pkl (protocol 2) with the widths, the wtoi
    pickle and an `nmt.train.pt` with the recipe's dicts."""
    import argparse
    import os
    import pickle

    import torch

    gen = torch.Generator().manual_seed(0)
    v1, e, h, a = (CAP["vocab_size"] + 1, CAP["input_encoding_size"],
                   CAP["rnn_size"], CAP["att_hid_size"])
    fc, att = CAP["fc_feat_size"], CAP["att_feat_size"]
    sv, tv, we = (NMT["src_vocab_size"], NMT["tgt_vocab_size"],
                  NMT["word_vec_size"])

    def t(*shape):
        return torch.randn(*shape, generator=gen) * MIGRATE_SCALE

    def lin(d, p, i, o, bias=True):
        d[p + ".weight"] = t(o, i)
        if bias:
            d[p + ".bias"] = t(o)

    cap = {"embed.0.weight": t(v1, e)}
    lin(cap, "fc_embed.0", fc, h)
    lin(cap, "att_embed.0", att, h)
    lin(cap, "ctx2att", h, a)
    lin(cap, "logit", h, v1)
    for i in range(3):
        lin(cap, f"core.lstm{i}.i2h", 2 * h, 5 * h)
        lin(cap, f"core.lstm{i}.h2h", h, 5 * h)
    for k in ("att1", "att2"):
        lin(cap, f"core.{k}.h2att", h, a)
        lin(cap, f"core.{k}.alpha_net", a, 1)
    lin(cap, "core.emb2", h, h)
    lin(cap, "core.fusion1.0", 2 * h, h)
    lin(cap, "core.fusion2.0", 3 * h, h)
    nmt = {"encoder.embeddings.word_lut.weight": t(sv, we),
           "decoder.embeddings.word_lut.weight": t(tv, we)}
    for sfx in ("", "_reverse"):
        hd = h // 2
        nmt[f"encoder.rnn.weight_ih_l0{sfx}"] = t(4 * hd, we)
        nmt[f"encoder.rnn.weight_hh_l0{sfx}"] = t(4 * hd, hd)
        nmt[f"encoder.rnn.bias_ih_l0{sfx}"] = t(4 * hd)
        nmt[f"encoder.rnn.bias_hh_l0{sfx}"] = t(4 * hd)
    p = "decoder.rnn.layers.0"
    nmt.update({p + ".weight_ih": t(4 * h, we + h),
                p + ".weight_hh": t(4 * h, h), p + ".bias_ih": t(4 * h),
                p + ".bias_hh": t(4 * h)})
    lin(nmt, "decoder.attn.linear_in", h, h, bias=False)
    lin(nmt, "decoder.attn.linear_out", 2 * h, h, bias=False)
    lin(nmt, "generator.0", h, tv)

    ref = os.path.join(root, "reference")
    os.makedirs(ref, exist_ok=True)
    out = {"i2t_pth": os.path.join(ref, "model_i2t-best.pth"),
           "nmt_pth": os.path.join(ref, "model_nmt-best.pth"),
           "infos_pkl": os.path.join(ref, "infos-best.pkl"),
           "wtoi_zh": os.path.join(ref, "wtoi_zh.txt"),
           "nmt_pt": os.path.join(ref, "nmt.train.pt")}
    torch.save(cap, out["i2t_pth"])
    torch.save(nmt, out["nmt_pth"])
    opt = argparse.Namespace(
        caption_model="denseatt", rnn_size=h, input_encoding_size=e,
        att_hid_size=a, num_layers=CAP["num_layers"], fc_feat_size=fc,
        att_feat_size=att, seq_length=CAP["seq_length"], seq_per_img=5)
    with open(out["infos_pkl"], "wb") as f:
        pickle.dump({"opt": opt, "iter": 1000, "epoch": 30}, f, protocol=2)
    with open(files["input_json"]) as f:
        itow = json.load(f)["ix_to_word"]
    with open(out["wtoi_zh"], "wb") as f:
        pickle.dump({w: int(ix) for ix, w in itow.items()}, f, protocol=2)
    with open(files["input_nmt_dict"]) as f:
        dicts = json.load(f)
    rs = np.random.RandomState(3)
    torch.save({"train": {
        "src": [torch.from_numpy(rs.randint(4, sv, 12)) for _ in range(8)],
        "tgt": [torch.from_numpy(rs.randint(4, tv, 14)) for _ in range(8)]},
        "dicts": {side: {int(k): w for k, w in
                         dicts[side]["idx_to_label"].items()}
                  for side in ("src", "tgt")}}, out["nmt_pt"])
    return out


def _initial_weights_run(dev, root: str, files: dict, run: str) -> str:
    """A copy of run dir `run` whose last checkpoint holds the models as
    the trainer builds them (`init_params` from the config's seed, the
    captioner first); its path."""
    import os
    import shutil

    import torch

    from unpaired_image_captioning_tpu_torch.cli import eval_unpaired
    from unpaired_image_captioning_tpu_torch.config import parse_opt
    from unpaired_image_captioning_tpu_torch.models import setup
    from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
        make_nmt_model)
    from unpaired_image_captioning_tpu_torch.train.checkpoint import (
        CheckpointManager)

    cfg, _, _ = eval_unpaired.load_run(parse_opt(
        _eval_argv(files, run, load_best_score=0)))
    init = torch.Generator().manual_seed(cfg.seed)
    cap = setup(cfg, device=dev).init_params(init)
    nmt = make_nmt_model(cfg, device=dev).init_params(init)
    out = os.path.join(root, "initial")
    os.makedirs(out, exist_ok=True)
    for name in ("infos.json", "nmt_config.json", "src_dict.json",
                 "tgt_dict.json"):
        shutil.copy(os.path.join(run, name), out)
    CheckpointManager(out).save(i2t_state=cap.state_dict(),
                                nmt_state=nmt.state_dict())
    return out


def phase_eval_clis(dev, root: str, files: dict, full, wall_full) -> dict:
    """The eval and migration surface on the recipe's full-width run dirs
    (denseatt rnn 512 over 2,048-wide 196-slot features, the caption vocab
    9,487, the BiLSTM NMT 11,986 -> 8,571), in the recipe's directory:

    - `cli.eval_unpaired` on the joint run's last checkpoint at beam 5 ->
      15 against English references (a prediction in both languages for
      every test image, finite `en_lang_stats`) and `cli.eval_pivot`
      (through `cli.translate`) with the same zh and en predictions; the
      same on a twin of the run at the trainer's initial weights, where
      every caption must have words in both languages; `cli.eval_paired`
      on the denseatt and the transformer run dirs;
    - `cli.eval_pivot --image_folder` on EVAL_RAW_IMAGES images through
      RawImageLoader (B11) and ResNet-101 with random weights;
    - `scripts.migrate_reference` on a generated reference pair at the
      recipe's widths, `cli.eval_unpaired` on the result, and the migrated
      weights through `phase_agreement`'s card-vs-CPU check;
    - the recipe again with `--input_workers 2`, then with 0: every
      parameter and Adam moment equal to the full run's, bit for bit, and
      the walls and mean `read_time` of the two.

    Each CLI's wall and launches of B1, B2, B4 and B11 are logged; returns
    the launches over the phase."""
    import os

    import torch

    from unpaired_image_captioning_tpu_torch import pivot
    from unpaired_image_captioning_tpu_torch.cli import (eval_paired,
                                                          eval_pivot,
                                                          eval_unpaired)
    from unpaired_image_captioning_tpu_torch.config import parse_opt
    from unpaired_image_captioning_tpu_torch.models import setup
    from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
        make_nmt_model)
    from unpaired_image_captioning_tpu_torch.scripts import migrate_reference
    from unpaired_image_captioning_tpu_torch.vocab import CaptionVocab, Dict

    t_phase = time.perf_counter()
    totals = {k: 0 for k in EVAL_KERNELS}
    runs, shapes = [], {}
    run = os.path.join(root, "full")
    refs = _refs_json(root, files)
    # the last checkpoint (`--load_best_score 0`): cli.translate reads
    # model_nmt.pt, so eval_unpaired takes the NMT of the same step
    pivot_kw = dict(language_eval=1, input_coco_json=refs, load_best_score=0)
    test_ids = sorted(int(i) for i in json.load(open(refs)))
    # the recipe's run, and its twin at the trainer's initial weights
    # (seed 0), where every caption has words in both languages: the
    # recipe's 9 steps on random captions leave EOS the likeliest token
    pivot_runs = [("recipe run", run, False),
                  ("initial weights", _initial_weights_run(dev, root, files,
                                                           run), True)]
    for label, d, words in pivot_runs:
        # eval_pivot's captions come from eval_split, which rounds the
        # features to bf16 on the card (as JAX's does on a TPU);
        # eval_unpaired's route does not round, so it reads them through a
        # bf16 loader here: both CLIs then decode the same features
        with _bf16_features():
            fused = _run_cli(f"eval_unpaired, {label} (beam 5 -> 15, "
                             "bf16 loader)", eval_unpaired.main,
                             _eval_argv(files, d, **pivot_kw), totals, runs,
                             shapes)
        empty = {lang: sum(not p["caption"]
                           for p in fused[f"{lang}_predictions"])
                 for lang in ("zh", "en")}
        for lang in ("zh", "en"):
            preds = fused[f"{lang}_predictions"]
            if sorted(p["image_id"] for p in preds) != test_ids or (
                    words and empty[lang]):
                raise AssertionError(f"eval_unpaired, {label}: {lang} "
                                     f"predictions {preds}")
        stats = fused["en_lang_stats"]
        if not all(np.isfinite(list(stats.values()))):
            raise AssertionError(f"eval_unpaired, {label}: en_lang_stats "
                                 f"{stats}")
        log(f"eval_unpaired, {label}: empty captions of {EVAL_BATCH} zh "
            f"{empty['zh']}, en {empty['en']}; en CIDEr {stats['CIDEr']:.4g}"
            f", self-BLEU {fused['self_bleu']:.4g}; first: "
            f"{fused['zh_predictions'][0]['caption'][:60]!r} -> "
            f"{fused['en_predictions'][0]['caption'][:60]!r}")
        staged = _run_cli(f"eval_pivot, {label} (staged, cli.translate)",
                          eval_pivot.main, _eval_argv(files, d, **pivot_kw),
                          totals, runs, shapes)
        for lang in ("zh", "en"):
            if staged[f"{lang}_predictions"] != fused[f"{lang}_predictions"]:
                raise AssertionError(f"eval_pivot's {lang} predictions differ"
                                     f" from eval_unpaired's ({label})")
    for label, d in (("denseatt", run),
                     ("transformer", os.path.join(root, "transformer"))):
        out = _run_cli(f"eval_paired ({label})", eval_paired.main,
                       _eval_argv(files, d, language_eval=1), totals, runs,
                       shapes)
        if len(out["predictions"]) != EVAL_BATCH or not all(
                np.isfinite([out["loss"], *out["lang_stats"].values()])):
            raise AssertionError(f"eval_paired {label}: {out}")

    # the raw-image route: RawImageLoader (B11) + ResNet-101
    folder = os.path.join(root, "raw")
    os.makedirs(folder, exist_ok=True)
    make_image_folder(folder, EVAL_RAW_IMAGES)
    raw = _run_cli(f"eval_pivot --image_folder ({EVAL_RAW_IMAGES} images)",
                   eval_pivot.main,
                   _eval_argv(files, run, image_folder=folder,
                              batch_size=EVAL_RAW_IMAGES, id="raw"),
                   totals, runs, shapes)
    if runs[-1][2]["image_front_end"] < 1 or len(
            raw["en_predictions"]) != EVAL_RAW_IMAGES:
        raise AssertionError(f"eval_pivot --image_folder: {runs[-1]}, {raw}")

    # reference checkpoints in
    t0 = time.perf_counter()
    ref = make_reference_pair(root, files)
    migrated = os.path.join(root, "migrated")
    with _quiet():
        migrate_reference.main(["--out_dir", migrated,
                                "--caption_model", "denseatt"]
                               + [x for k, v in ref.items()
                                  for x in ("--" + k, v)])
    log(f"migrate_reference: {time.perf_counter() - t0:.2f} s (host; the "
        "reference pair generated and converted)")
    mig = _run_cli("eval_unpaired (migrated)", eval_unpaired.main,
                   _eval_argv(files, migrated,
                              **dict(pivot_kw, load_best_score=1)),
                   totals, runs, shapes)
    if not all(p["caption"] for p in mig["zh_predictions"]):
        raise AssertionError("migrated eval_unpaired: an empty zh caption")
    cfg, ckpt, best = eval_unpaired.load_run(
        parse_opt(_eval_argv(files, migrated)))
    with open(files["input_json"]) as f:
        vocab = CaptionVocab(json.load(f)["ix_to_word"])
    cfg.vocab_size = vocab.vocab_size
    cap = eval_unpaired.load_model(lambda d: setup(cfg, device=d), ckpt,
                                   "model_i2t", best, dev)
    nmt = eval_unpaired.load_model(lambda d: make_nmt_model(cfg, device=d),
                                   ckpt, "model_nmt", best, dev)
    with open(os.path.join(migrated, "src_dict.json")) as f:
        src_dict = Dict.from_state_dict(json.load(f))
    phase_agreement(dev, cap, nmt,
                    pivot.build_caption_to_nmt_map(vocab, src_dict))
    del cap, nmt
    torch.cuda.empty_cache()

    # the feature workers: the recipe with --input_workers 2, then once
    # more without, both warm (the full run was the process's first)
    walls, reads = {}, {}
    for n in (2, 0):
        again, walls[n], ev = _recipe_run(
            files, os.path.join(root, f"workers{n}"), input_workers=n)
        _same_state(full, again, f"recipe --input_workers {n}")
        # step 1's read waits for the workers' start; the mean of the rest
        r = [e["read_time"] * 1e3 for e in _steps(ev)]
        reads[n] = f"{r[0]:.1f} then {statistics.mean(r[1:]):.1f}"
        # each step's, for the stall after an eval (steps 5 and 9 follow
        # the evals after steps 4 and 8) against the workers' own cost
        log(f"recipe --input_workers {n}: read_time of steps 1-{len(r)} "
            + ", ".join(f"{x:.1f}" for x in r) + " ms")
        del again
    log(f"recipe wall: --input_workers 2 {walls[2]:.1f} s, 0 {walls[0]:.1f} s"
        f" (the process's first, the full run above: {wall_full:.1f} s); "
        f"read_time of step 1, then the mean of steps 2-9: workers "
        f"{reads[2]} ms, none {reads[0]} ms; parameters and Adam moments "
        "equal to the full run's bit for bit")
    torch.cuda.empty_cache()
    for name in ("lstm_cell", "row_topk", "transformer_decode_stack",
                 "image_front_end"):
        if not totals[name]:
            raise AssertionError(f"eval CLIs: {name} was not launched")
    # every shape the CLIs gave a kernel is one the kernel checks hold
    held = _held_eval_shapes()
    for name in EVAL_KERNELS:
        seen = shapes.get(name, set())
        log(f"eval CLIs {name} shapes: {sorted(seen, key=str)}")
        unheld = _unheld(dev, name, seen, held[name])
        if unheld:
            raise AssertionError(
                f"eval CLIs: {name} ran at {sorted(unheld, key=str)}"
                ", which no kernel check holds against the plain version")
    log(f"eval CLIs launches: {json.dumps(totals)}")
    log(f"eval CLIs phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


# raw files to a trained, profiled model on the port alone: AIC-style
# annotations of the recipe's 160 images (5 captions of RAW_CAPTION_LEN
# characters each), a zh-en text corpus of the recipe's pair counts and a
# bottom-up TSV (RAW_BOXES boxes x 2,048 f32 an image), all from seed 0,
# through the port's preprocessing into cli.train, Trainer.profile and
# back-translation. A character of the CJK block is a caption word (the
# per-character route of segment_zh, which the card's machine takes).
# Captions and corpus lines carry the frequent words of their language at
# fixed places (AIC captions open with 一个, "a"), the rest are drawn.
RAW_CJK = 0x4E00
RAW_CAPTION_LEN = 30
RAW_ZH_FRAME = {0: "一", 1: "个", 3: "着", 5: "的", 7: "在", 10: "的"}
RAW_EN_FRAME = {0: "a", 3: "in", 4: "a", 6: "the"}
RAW_THRESHOLD = 1         # --word_count_threshold: words seen once -> UNK
ZH_UNK_WORD = "卍"        # prepro_labels' UNK, the vocabulary's last word
RAW_BOXES = 36
RAW_EXTRA_WORDS = 1000    # corpus words past each dict's size (pruned)
RAW_BPE_MERGES = 30
RAW_PROFILE_STEPS = 3
RAW_BT_BEAM = 5
# cli.train: XE only, to the end of epoch 2 (the loader notes its first
# wrap a step late: 3 + 2 steps), an eval and a checkpoint at step 4
RAW_TRAIN = dict(self_critical_after=-1, max_epochs=2,
                 save_checkpoint_every=4)
RAW_STEPS = 5
# the kernels of the path (default attention flags), by counter: the
# name their launches bear in a trace
RAW_KERNELS = {"lstm_cell": "lstm_cell_kernel",
               "row_topk": "topk_select_kernel"}


def _zh_words():
    """CJK characters in code-point order, the frame's left out."""
    frame = set(RAW_ZH_FRAME.values())
    return (c for c in map(chr, range(RAW_CJK, 0xA000)) if c not in frame)


def _en_word(i: int) -> str:
    """The i-th pseudo-English word: i in base 26, three letters or more
    (none of them a frame word)."""
    i += 26 * 26
    out = ""
    while i:
        i, r = divmod(i, 26)
        out = chr(ord("a") + r) + out
    return out


def _framed(lengths, frame: dict, toks) -> list:
    """Lines of the given lengths: `frame`'s words at their places, the
    next of `toks` everywhere else."""
    toks = iter(toks)
    return [[frame[j] if j in frame else next(toks) for j in range(n)]
            for n in lengths]


def _corpus_lines(rs, n_lines, max_len, n_once, n_skew, words, frame):
    """n_lines lines of 8..max_len words around `frame`: words[0..n_once)
    once each, the rest drawn from words[0..n_skew) (so those survive the
    prune)."""
    lengths = rs.randint(8, max_len + 1, n_lines)
    free = int(lengths.sum()) - len(frame) * n_lines
    toks = list(range(n_once)) + list(rs.randint(0, n_skew, free - n_once))
    rs.shuffle(toks)
    return [" ".join(line) for line in
            _framed(lengths, frame, (words[t] for t in toks))]


def make_raw_inputs(root: str) -> dict:
    """The raw inputs under `root`, from seed 0: AIC annotations in two
    files (train and validation, as AIC ships them) whose frame words and
    9,481 other words each appear twice or more, and some more characters
    once (so prepro_labels at RAW_THRESHOLD keeps CAP's 9,487 entries with
    UNK); train and valid text corpora (zh: the caption characters and
    RAW_EXTRA_WORDS more than NMT's source dict keeps; en: likewise for the
    target dict); and one bottom-up TSV (image ids 0..159, the ids
    prepro_split_tokenize assigns)."""
    import base64
    import csv
    import itertools
    import os

    rs = np.random.RandomState(0)
    n_img = sum(RECIPE_SPLITS)
    n_caps = 5 * n_img
    n_frame = len(set(RAW_ZH_FRAME.values()))
    n_words = CAP["vocab_size"] - 1 - n_frame
    free = RAW_CAPTION_LEN - len(RAW_ZH_FRAME)
    singles = n_caps * free - 2 * n_words
    zh = list(itertools.islice(_zh_words(), n_words + singles + 10000))
    toks = list(range(n_words)) * 2 + list(range(n_words, n_words + singles))
    rs.shuffle(toks)
    caps = ["".join(c) for c in _framed([RAW_CAPTION_LEN] * n_caps,
                                        RAW_ZH_FRAME, (zh[t] for t in toks))]
    anns = [{"image_id": f"{i:012d}.jpg", "caption": caps[5 * i: 5 * i + 5]}
            for i in range(n_img)]
    out = {"annotations": []}
    for name, part in (("train", anns[:130]), ("validation", anns[130:])):
        path = os.path.join(root, f"caption_{name}_annotations.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(part, f, ensure_ascii=False)
        out["annotations"].append(path)

    src_once = NMT["src_vocab_size"] + RAW_EXTRA_WORDS
    tgt_once = NMT["tgt_vocab_size"] + RAW_EXTRA_WORDS
    en = [_en_word(i) for i in range(tgt_once)]
    zh_frame = {0: RAW_ZH_FRAME[0], 1: RAW_ZH_FRAME[1]}
    lines = {"zh": _corpus_lines(rs, RECIPE_PAIRS, NMT_SRC_LEN, src_once,
                                 n_words, zh, zh_frame),
             "en": _corpus_lines(rs, RECIPE_PAIRS, NMT_TGT_LEN - 2,
                                 tgt_once, NMT["tgt_vocab_size"], en,
                                 RAW_EN_FRAME)}
    valid = {}
    for lang, words, once, n, frame in (
            ("zh", zh, src_once, NMT_SRC_LEN, zh_frame),
            ("en", en, tgt_once, NMT_TGT_LEN - 2, RAW_EN_FRAME)):
        lengths = rs.randint(8, n + 1, RECIPE_VALID_PAIRS)
        draws = rs.randint(0, once, int(lengths.sum()))
        valid[lang] = [" ".join(line) for line in _framed(
            lengths, frame, (words[t] for t in draws))]
    for split, part in (("train", lines), ("valid", valid)):
        for lang in ("zh", "en"):
            path = os.path.join(root, f"{split}.{lang}")
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(part[lang]) + "\n")
            out[f"{split}_{lang}"] = path

    out["tsv"] = os.path.join(root, "bottom_up.tsv")
    with open(out["tsv"], "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for iid in range(n_img):
            boxes = (rs.rand(RAW_BOXES, 4) * 500).astype(np.float32)
            feats = np.abs(rs.randn(RAW_BOXES, CAP["att_feat_size"])
                           ).astype(np.float32)
            w.writerow([iid, 640, 480, RAW_BOXES,
                        base64.b64encode(boxes.tobytes()).decode(),
                        base64.b64encode(feats.tobytes()).decode()])
    return out


def preprocess_raw(root: str, raw: dict) -> dict:
    """The port's preprocessing of the raw inputs, in the paper's order:
    prepro_split_tokenize -> prepro_labels (.npz) -> prepro_ngrams ->
    prepro_reference_json (val and test) -> cli.preprocess (the dicts
    pruned to NMT's sizes; once more learning RAW_BPE_MERGES BPE merges on
    the English side) -> the dicts joined as a user joins them ->
    make_bu_data. Returns the cli.train files and the reference JSONs;
    checks the sizes."""
    import os

    from unpaired_image_captioning_tpu_torch.cli import preprocess
    from unpaired_image_captioning_tpu_torch.scripts import (
        make_bu_data, prepro_labels, prepro_ngrams, prepro_reference_json,
        prepro_split_tokenize)

    n_train, n_val, n_test = RECIPE_SPLITS
    j = lambda name: os.path.join(root, name)  # noqa: E731
    with _quiet():
        prepro_split_tokenize.main(
            ["--inputs", *raw["annotations"], "--output", j("raw.json"),
             "--num_val", str(n_val), "--num_test", str(n_test)])
        prepro_labels.main(
            ["--input_json", j("raw.json"), "--output_json", j("talk.json"),
             "--output_h5", j("label.npz"),
             "--max_length", str(CAP["seq_length"]),
             "--word_count_threshold", str(RAW_THRESHOLD)])
        prepro_ngrams.main(["--input_label_h5", j("label.npz"),
                            "--input_json", j("talk.json"),
                            "--output", j("ngrams.npz")])
        for split in ("val", "test"):
            prepro_reference_json.main(
                ["--input_json", j("talk.json"), "--input_label_h5",
                 j("label.npz"), "--output", j(f"{split}_refs.json"),
                 "--split", split])
        common = ["-train_src", raw["train_zh"], "-train_tgt",
                  raw["train_en"], "-valid_src", raw["valid_zh"],
                  "-valid_tgt", raw["valid_en"],
                  "-src_vocab_size", str(NMT["src_vocab_size"]),
                  "-tgt_vocab_size", str(NMT["tgt_vocab_size"])]
        preprocess.main(common + ["-save_data", j("nmt")])
        os.makedirs(j("bpe"), exist_ok=True)
        preprocess.main(common + ["-save_data", j("bpe/nmt"),
                                  "-tgt_bpe_merges", str(RAW_BPE_MERGES)])
        make_bu_data.main(["--input_tsvs", raw["tsv"], "--output_dir",
                           j("bu"), "--feat_dim",
                           str(CAP["att_feat_size"])])
    with open(j("talk.json"), encoding="utf-8") as f:
        itow = json.load(f)["ix_to_word"]
    dicts = {}
    for side in ("src", "tgt"):
        with open(j(f"nmt.{side}_dict.json")) as f:
            dicts[side] = json.load(f)
    with open(j("dicts.json"), "w") as f:
        json.dump(dicts, f)
    sizes = {side: len(d["idx_to_label"]) for side, d in dicts.items()}
    with open(j("bpe/nmt.tgt_bpe.codes"), encoding="utf-8") as f:
        merges = sum(1 for line in f if not line.startswith("#"))
    with open(j("raw.json"), encoding="utf-8") as f:
        splits = [im["split"] for im in json.load(f)]
    log(f"raw data: prepro_labels vocabulary {len(itow)} (threshold "
        f"{RAW_THRESHOLD}, the last {itow[str(len(itow))]!r}); "
        f"splits train {splits.count('train')} / val {splits.count('val')}"
        f" / test {splits.count('test')}; cli.preprocess dicts src "
        f"{sizes['src']} / tgt {sizes['tgt']}; {merges} BPE merges learned "
        "on the English side")
    if (len(itow), itow[str(len(itow))]) != (CAP["vocab_size"],
                                             ZH_UNK_WORD) or (
            sizes["src"], sizes["tgt"]) != (NMT["src_vocab_size"],
                                            NMT["tgt_vocab_size"]):
        raise AssertionError(f"raw data: vocabulary {len(itow)}, "
                             f"dicts {sizes}")
    if splits.count("val") != n_val or splits.count("test") != n_test or (
            merges != RAW_BPE_MERGES):
        raise AssertionError(f"raw data: splits or BPE merges ({merges})")
    corpus = np.load(j("nmt.train.npz"))
    if corpus["src"].shape[0] != RECIPE_PAIRS or corpus["src"].dtype != \
            np.int32:
        raise AssertionError(f"raw data: corpus {corpus['src'].shape}")
    att = np.load(j(f"bu_att/{n_train}.npz"))["feat"]
    if att.shape != (RAW_BOXES, CAP["att_feat_size"]):
        raise AssertionError(f"raw data: att features {att.shape}")
    return {"files": dict(input_json=j("talk.json"),
                          input_label_h5=j("label.npz"),
                          input_fc_dir=j("bu_fc"), input_att_dir=j("bu_att"),
                          input_nmt_h5=j("nmt.train.npz"),
                          input_nmt_dict=j("dicts.json"),
                          cached_tokens=j("ngrams.npz")),
            "val_refs": j("val_refs.json"), "test_refs": j("test_refs.json")}


def _trace_device_ops(trace_dir: str) -> dict:
    """{device operation name: (summed us, count)} of the Chrome trace
    `trace.json` that Trainer.profile wrote: kernels, copies and sets."""
    import os

    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    per: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            us, n = per.get(e["name"], (0.0, 0))
            per[e["name"]] = (us + float(e.get("dur", 0.0)), n + 1)
    return per


def phase_raw_data(dev) -> dict:
    """Raw annotations to a trained, profiled model on the port alone, at
    the recipe's full widths (CAP, NMT): `make_raw_inputs` and
    `preprocess_raw` on the host, then on the card `cli.train` (the joint
    denseatt + BiLSTM NMT, RAW_TRAIN: 5 XE steps at batch 50 x 5 captions,
    an in-loop eval at beam 3 over the 50 val images), `Trainer.profile`
    over RAW_PROFILE_STEPS steps (its trace must name every kernel whose
    count those steps moved; the five device operations that took the most
    time are logged), `prepro_backtranslate --provider nmt` on the run dir
    (the test images' first reference captions, beam RAW_BT_BEAM: B1 and B2
    must launch), and the reports (`html_report`, `word_cloud_from_captions`,
    `vis_words`) on the eval's predictions. Every shape the path gives B1
    and B2 must be one a kernel check holds. Returns the launches."""
    import os
    import tempfile

    import torch

    from unpaired_image_captioning_tpu_torch.cli import train as cli
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.scripts import (
        prepro_backtranslate)
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer
    from unpaired_image_captioning_tpu_torch.utils.report import html_report
    from unpaired_image_captioning_tpu_torch.utils.vis_words import vis_words
    from unpaired_image_captioning_tpu_torch.utils.word_cloud import (
        word_cloud_from_captions)

    counters = {"lstm_cell": (lk, "launches"), "row_topk": (tk, "launches")}

    def read():
        return {k: getattr(*c) for k, c in counters.items()}

    t_phase = time.perf_counter()
    here = os.getcwd()
    shapes: dict = {}
    with tempfile.TemporaryDirectory(prefix="raw-") as root:
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            raw = make_raw_inputs(root)
            t_gen = time.perf_counter() - t0
            t0 = time.perf_counter()
            prep = preprocess_raw(root, raw)
            t_prep = time.perf_counter() - t0
            run = os.path.join(root, "run")
            evals = []
            eval_fn = Trainer.eval

            def keep_eval(self, *a, **kw):
                out = eval_fn(self, *a, **kw)
                evals.append(out)
                return out

            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            Trainer.eval = keep_eval
            try:
                with _recording_shapes(shapes):
                    trainer, wall_train, ev = _recipe_run(
                        prep["files"], run, **RAW_TRAIN)
            finally:
                Trainer.eval = eval_fn
            after_train = read()
            steps = _steps(ev)
            if len(steps) != RAW_STEPS or len(evals) != 1 or not all(
                    np.isfinite(e["total_loss"]) for e in steps):
                raise AssertionError(f"raw data: {len(steps)} steps, "
                                     f"{len(evals)} evals")
            # the profile: batches from a loader built as the CLI builds it
            nmt_dataset, _, _ = cli._nmt_data(trainer.cfg)
            loader = cli.build_loader(trainer.cfg, nmt_dataset)
            before = read()
            with _recording_shapes(shapes):
                prof = trainer.profile(
                    iter(lambda: loader.get_batch("train"), None),
                    n_steps=RAW_PROFILE_STEPS)
            moved = {k: n - before[k] for k, n in read().items()
                     if n > before[k]}
            ops = _trace_device_ops(prof["trace_dir"])
            top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]
            busy = sum(us for us, _ in ops.values()) / 1e3
            trace_mb = os.path.getsize(os.path.join(
                prof["trace_dir"], "trace.json")) / 1e6
            log(f"Trainer.profile: {prof['steps']} steps, mean "
                f"{prof['mean_step_s'] * 1e3:.1f} ms, least "
                f"{prof['min_step_s'] * 1e3:.1f} ms a step; trace "
                f"{trace_mb:.1f} MB, {sum(n for _, n in ops.values())} "
                f"device operations, {busy:.1f} ms on the card over the "
                f"{prof['steps']} steps")
            log("Trainer.profile top device operations: " + "; ".join(
                f"{short_name(name)[:48]} {us / 1e3:.2f} ms x {n}"
                for name, (us, n) in top))
            named = {k: sum(n for name, (_, n) in ops.items()
                            if RAW_KERNELS[k] in name) for k in moved}
            log(f"Trainer.profile kernels: counters moved {json.dumps(moved)}"
                f", trace names {json.dumps(named)}")
            if set(prof) != {"trace_dir", "steps", "mean_step_s",
                             "min_step_s"} or "lstm_cell" not in moved or \
                    not all(named.values()):
                raise AssertionError(f"raw data: profile {prof}, counters "
                                     f"{moved}, trace {named}")
            # back-translation of the test images' first references
            with open(prep["test_refs"], encoding="utf-8") as f:
                refs = json.load(f)
            first = {}
            for a in refs["annotations"]:
                first.setdefault(a["image_id"], a["caption"])
            zh = os.path.join(root, "test.zh")
            with open(zh, "w", encoding="utf-8") as f:
                f.write("\n".join(first.values()) + "\n")
            before = read()
            t0 = time.perf_counter()
            with _quiet(), _recording_shapes(shapes):
                prepro_backtranslate.main(
                    ["--input", zh, "--output", os.path.join(root, "bt.en"),
                     "--nmt_run", run, "--beam_size", str(RAW_BT_BEAM)])
            torch.cuda.synchronize()
            wall_bt = time.perf_counter() - t0
            bt = {k: n - before[k] for k, n in read().items()}
            with open(os.path.join(root, "bt.en"), encoding="utf-8") as f:
                en = f.read().splitlines()
            if len(en) != len(first) or not (bt["lstm_cell"]
                                              and bt["row_topk"]):
                raise AssertionError(f"raw data: back-translation {len(en)} "
                                     f"lines of {len(first)}, launches {bt}")
            counts = read()
            # the reports on the eval's predictions
            preds = evals[0]["predictions"]
            with open(prep["val_refs"], encoding="utf-8") as f:
                val_refs = json.load(f)
            by_image: dict = {}
            for a in val_refs["annotations"]:
                by_image.setdefault(a["image_id"], []).append(a["caption"])
            report = html_report(preds, os.path.join(root, "report.html"),
                                 references=by_image)
            cloud = word_cloud_from_captions(
                [p["caption"] for p in preds], os.path.join(root, "wc.svg"))
            scatter = vis_words([p["caption"] for p in preds],
                                [c for cs in by_image.values() for c in cs],
                                os.path.join(root, "vis.html"),
                                label_a="predictions", label_b="references")
            with open(report, encoding="utf-8") as f:
                items = f.read().count("<div class=item>")
            with open(scatter, encoding="utf-8") as f:
                points = f.read().count("<circle")
            if len(preds) != RECIPE_SPLITS[1] or items != len(preds) or \
                    "<svg" not in cloud or not points:
                raise AssertionError(f"raw data: {len(preds)} predictions, "
                                     f"{items} report items, {points} points")
            log(f"raw data reports: {items} report items, "
                f"{cloud.count('<text')} cloud words, {points} scatter points"
                f"; empty predictions {sum(not p['caption'] for p in preds)}"
                f" of {len(preds)}; back-translation {len(en)} lines, first "
                f"{first[next(iter(first))][:40]!r} -> {en[0][:40]!r}")
            xe = ", ".join(f"{e['step_time'] * 1e3:.1f}" for e in steps[1:])
            t_eval = next(e["eval_time"] for e in ev if "eval_time" in e)
            log(f"raw data walls: inputs {t_gen:.1f} s, preprocessing "
                f"{t_prep:.1f} s (host); cli.train {wall_train:.1f} s (XE "
                f"steps 2-{RAW_STEPS} {xe} ms, eval {t_eval:.2f} s); "
                f"back-translation {wall_bt:.2f} s; launches: cli.train "
                f"{json.dumps(after_train)}, profile {json.dumps(moved)}, "
                f"back-translation {json.dumps(bt)}")
        finally:
            os.chdir(here)
    held = _held_eval_shapes()
    for name in ("lstm_cell", "row_topk"):
        seen = shapes.get(name, set())
        log(f"raw data {name} shapes: {sorted(seen, key=str)}")
        unheld = _unheld(dev, name, seen, held[name])
        if unheld:
            raise AssertionError(
                f"raw data: {name} ran at {sorted(unheld, key=str)}, which "
                "no kernel check holds against the plain version")
    log(f"raw data launches: {json.dumps(counts)}")
    log(f"raw data phase: {time.perf_counter() - t_phase:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the other caption families (ROADMAP A10)
# ---------------------------------------------------------------------------

# the eleven families of A10 at CAP's widths (StackCap's 1,601 attributes)
FAMILIES = ("fc", "topdown", "att2in", "att2in2", "att2all2", "adaatt",
            "adaattmo", "show_tell", "all_img", "show_attend_tell",
            "stackcap")
FAM = dict(CAP, attri_feat_size=1601)
# Trainer steps at the loader's batch 10 x 5 (features repeated); SCST
# rewards from BLEU-4 (no df table needed)
FAM_TRAIN = dict(FAM, batch_size=10, seq_per_img=5, i2t_train_flag=True,
                 i2t_learning_rate=5e-4, seed=0, cider_reward_weight=0.0,
                 bleu_reward_weight=1.0, dtype="float32")
FAM_BEAM, FAM_IMAGES, FAM_AGREE = 3, 50, 4
# (label, D, H, maxout): the cells the families give B1 at CAP's widths
FAMILY_CELLS = [
    ("fc core", 512, 512, True),
    ("topdown att_lstm", 1536, 512, False),
    ("topdown lang_lstm", 1024, 512, False),
    ("show_tell core", 512, 512, False),
    ("all_img / show_attend_tell core", 2560, 512, False),
    ("stackcap lstm0", 1024, 512, True),
    ("stackcap lstm1 / lstm2", 1536, 512, True),
]
# the rows of those cells: 4 images teacher-forced and at beam 3 (12), an
# eval batch of 10 images (fc's image step before the beams) and at beam 3
# (30), the batch of 10 x 5 captions (50), a beam-3 decode of 50 images
# (150) and the XE rows of 50 images x 5 captions (250)
FAMILY_ROWS = (4, 10, 12, 30, 50, 150, 250)
FAMILY_TIMED_ROWS = (250, 150)
# (label, R, V, k): the beam-3 selections of 4 and 10 images (50 images:
# TOPK_SHAPES' "caption beam 3 x 50")
FAMILY_TOPK = [("caption beam 3 x 4", 12, 9488, 3),
               ("caption beam 3 x 10", 30, 9488, 3)]
# train.sh's func_i2t_xe_rl for fc and stackcap through cli.train on
# FAM_SPLITS images (train, val, test; 5 captions each) at batch 10 x 5:
# XE for 2 epochs (4 steps, an eval at beam 3 and a checkpoint every 2),
# then SCST from epoch 2 with --start_from for 2 epochs (4 steps)
FAM_SPLITS = (20, 10, 10)
FAM_RECIPE = dict(
    nmt_train_flag="false", batch_size=10, seq_per_img=5, beam_size=3,
    val_images_use=10, save_checkpoint_every=2, language_eval=1,
    load_best_score=0, i2t_learning_rate=5e-4, scheduled_sampling_start=0,
    self_critical_after=-1, max_epochs=2, rnn_size=CAP["rnn_size"],
    input_encoding_size=CAP["input_encoding_size"],
    att_hid_size=CAP["att_hid_size"], num_layers=CAP["num_layers"],
    fc_feat_size=CAP["fc_feat_size"], att_feat_size=CAP["att_feat_size"],
    dtype="float32")
FAM_SCST = dict(self_critical_after=2, max_epochs=4, i2t_learning_rate=5e-5,
                scheduled_sampling_start=-1)
# the B9 route flags of models/att.py, all on for TopDown's decode
B9_FLAGS = dict(STEP_FUSION=True, BEAMS_KERNEL=True, SINGLE_KERNEL=True,
                TRAIN_KERNEL=True)


def _family_cells(dev, cell_rows=None, topk_shapes=FAMILY_TOPK,
                  timed=None, topk_timed=None, special=None,
                  seed: int = 18) -> tuple:
    """B1 at each FAMILY_CELLS shape and FAMILY_ROWS row count against the
    plain cell, forward and backward (the Function's backward: the gates
    recomputed by the plain version, then autodiff), and B2 at
    FAMILY_TOPK, exact; the cells timed at FAMILY_TIMED_ROWS. Another
    phase passes its own `cell_rows` [(label, D, H, maxout, rows)],
    `topk_shapes`, the (B, D, H) it times (`timed`) and the (R, V, k) of
    the top-k rows it times (`topk_timed`, all when None). Returns (the
    cells' records, the top-k records)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk

    if cell_rows is None:
        cell_rows = [c + (FAMILY_ROWS,) for c in FAMILY_CELLS]
        timed = {(b, d, h) for _, d, h, _ in FAMILY_CELLS
                 for b in FAMILY_TIMED_ROWS}
    gen = torch.Generator(device=dev).manual_seed(seed)
    cells, worst = [], 0.0
    for label, d, h, maxout, rows in cell_rows:
        g = 5 if maxout else 4
        for b in rows:
            scale = 1.0 / h ** 0.5
            w = (torch.rand((d + h, g * h), generator=gen, device=dev) * 2
                 - 1) * scale
            bias = (torch.rand((g * h,), generator=gen, device=dev) * 2
                    - 1) * scale
            x, h0, c0, gh, gc = (torch.randn((b, m), generator=gen,
                                             device=dev)
                                 for m in (d, h, h, h, h))
            ins = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
            ref = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
            hk, ck = lk.lstm_cell(*ins, maxout=maxout)
            hp, cp = lk.lstm_cell_plain(*ref, maxout=maxout)
            fwd = max((hk - hp).abs().max().item(),
                      (ck - cp).abs().max().item())
            if not fwd <= LSTM_TOL or hk.grad_fn is None:
                raise AssertionError(f"lstm_cell {label} [{b}, {d}->{h}]: "
                                     f"max|diff| {fwd} > {LSTM_TOL} or no "
                                     "grad_fn")
            got = torch.autograd.grad((hk, ck), ins, (gh, gc))
            want = torch.autograd.grad((hp, cp), ref, (gh, gc))
            bwd = _att_check(f"lstm_cell backward {label} [{b}, {d}->{h}]",
                             got, want)
            worst = max(worst, fwd)
            row = dict(label=f"{label}, {b} rows", shape=f"G={g} [{b}, "
                       f"{d}->{h}]", err=fwd, backward_err=bwd)
            if (b, d, h) in timed:
                with torch.no_grad():
                    k_ms, p_ms, k_wall, p_wall, how = time_pair(
                        lambda: lk.lstm_cell(w, bias, x, h0, c0,
                                             maxout=maxout),
                        lambda: lk.lstm_cell_plain(w, bias, x, h0, c0,
                                                   maxout=maxout),
                        LSTM_KERNELS)
                b_ms, b_by = bound(nbytes(w, bias, x, h0, c0, hk, ck),
                                   2.0 * b * (d + h) * g * h)
                lib_ms = None
                if g == 4:
                    # torch.lstm_cell on the weights permuted once to its
                    # (i, f, g, o) blocks in [4H, in], as phase_kernels does
                    cols = torch.cat([torch.arange(j * h, (j + 1) * h,
                                                   device=dev)
                                      for j in (0, 1, 3, 2)])
                    w_ih = w[:d, cols].t().contiguous()
                    w_hh = w[d:, cols].t().contiguous()
                    b_ih = bias[cols].contiguous()
                    b_hh = torch.zeros_like(bias)
                    with torch.no_grad():
                        lib_ms = library_ms(lambda: torch.lstm_cell(
                            x, (h0, c0), w_ih, w_hh, b_ih, b_hh))[0]
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms, timing=how,
                           wall_ms=k_wall, plain_wall_ms=p_wall)
                log(f"kernel lstm_cell G={g} [{b}, {d}->{h}] ({label}): "
                    f"{how}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; per "
                    f"call kernel {k_wall:.4f} ms, plain {p_wall:.4f} ms; "
                    f"bound {b_ms:.4f} ms ({b_by}); library: "
                    + (f"torch.lstm_cell on permuted weights {lib_ms:.4f} ms"
                       if lib_ms is not None else "none (maxout cell)")
                    + f"; plan {lk.plan(b, d, h)}")
            cells.append(row)
    log(f"kernel lstm_cell at {len(cells)} shapes ("
        + "; ".join(f"{c[0]} x rows {c[4]}" for c in cell_rows)
        + f"): forward max|diff| "
        f"{worst:.3g} (tol {LSTM_TOL}), backward max|diff| / max(1, "
        f"max|plain|) {max(r['backward_err'] for r in cells):.3g} (tol "
        f"{ATT_TOL})")
    topk = []
    for label, r, v, k, x in _topk_cases(dev, topk_shapes,
                                         special or _few_beam_rows):
        got, want = tk.row_topk(x, k), tk.row_topk_plain(x, k)
        _same_topk(f"row_topk {label}", got, want)
        if topk_timed is not None and (r, v, k) not in topk_timed:
            topk.append(dict(label=label, shape=f"[{r}, {v}] k={k}"))
            log(f"kernel row_topk [{r}, {v}] k={k} ({label}): exact")
            continue
        k_ms, p_ms, _, _, how = time_pair(lambda: tk.row_topk(x, k),
                                          lambda: tk.row_topk_plain(x, k),
                                          "topk_select_kernel")
        b_ms, b_by = bound(nbytes(x, *got), float(r * v))
        topk.append(dict(label=label, shape=f"[{r}, {v}] k={k}", ms=k_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms(
                             lambda: torch.topk(x, k, dim=1))[0],
                         timing=how))
        log(f"kernel row_topk [{r}, {v}] k={k} ({label}): exact; {how}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {b_ms:.4f} ms"
            f" ({b_by})")
    return cells, topk


def _few_beam_rows(x, k: int) -> None:
    """`_beam_rows` where x has the rows for it, else (12 rows) the NaN rows
    of `_nan_rows`, four rows of exact ties, an all -inf row and a dead
    beam row."""
    if x.shape[0] >= 19:
        _beam_rows(x, k)
        return
    _nan_rows(x, 0, k)
    x[5:9] = (x[5:9] * 2).round() / 2
    x[9] = float("-inf")
    x[10] = -1e10


def _fam_features(rs, n: int, dev):
    import torch

    from unpaired_image_captioning_tpu_torch.models.base import Features

    fc, att = make_features(rs, n)
    masks = np.ones((n, N_SLOTS), np.float32)
    masks[0, 150:] = 0.0
    attri = rs.rand(n, FAM["attri_feat_size"]).astype(np.float32)
    return Features(*(torch.as_tensor(a, device=dev)
                      for a in (fc, att, attri, masks)))


def _fam_batch(rs) -> dict:
    """A host batch of FAM_TRAIN's 10 images x 5 captions (features
    repeated, as the loader repeats them) with SCST's gts."""
    b, spi = FAM_TRAIN["batch_size"], FAM_TRAIN["seq_per_img"]
    t, v = CAP["seq_length"], CAP["vocab_size"]
    img = make_train_batch(rs, b)
    batch = {k: np.repeat(img[k], spi, axis=0)
             for k in ("fc_feats", "att_feats", "att_masks")}
    batch["attri_feats"] = np.repeat(
        rs.rand(b, FAM["attri_feat_size"]).astype(np.float32), spi, axis=0)
    lengths = rs.randint(5, t + 1, b * spi)
    words = rs.randint(1, v + 1, (b * spi, t + 2))
    pos = np.arange(t + 2)[None, :]
    batch["labels"] = np.where((pos >= 1) & (pos <= lengths[:, None]),
                               words, 0).astype(np.int64)
    batch["masks"] = (pos <= lengths[:, None] + 1).astype(np.float32)
    gts = batch["labels"][:, 1:].reshape(b, spi, -1)
    batch["gts"] = np.repeat(gts, spi, axis=0)
    batch["gts_masks"] = np.ones((b * spi, spi), np.float32)
    return batch


def _fam_xe_loss(trainer, batch) -> float:
    """The captioner's XE loss on `batch` without dropout or gradient."""
    import torch

    from unpaired_image_captioning_tpu_torch.losses.criterion import (
        language_model_loss)
    from unpaired_image_captioning_tpu_torch.models.base import Features

    up = trainer._batch(batch)
    feats = Features(fc_feats=up["fc_feats"], att_feats=up["att_feats"],
                     attri_feats=up["attri_feats"],
                     att_masks=up["att_masks"])
    with torch.no_grad():
        out = trainer.i2t_model.forward(feats, up["labels"], training=False)
        return float(language_model_loss(out, up["labels"][:, 1:],
                                         up["masks"][:, 1:]))


def _one_family(dev, name: str, shapes: dict) -> dict:
    """One family at FAM's widths: teacher-forced logprobs of FAM_AGREE
    images card vs CPU on the CPU's beam-3 tokens (within AGREE_TOL; the
    top beams' token agreement is logged), 2 XE steps and 1 SCST step of
    `Trainer.train` at batch 10 x 5 (finite, the XE loss falling, a
    reward), and a beam-3 decode of FAM_IMAGES images. Returns its
    walls."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    walls = {}
    t0 = time.perf_counter()
    with _recording_shapes(shapes):
        trainer = Trainer(Config(**dict(FAM_TRAIN, caption_model=name))
                          .finalize(), device=dev)
        model = trainer.i2t_model
        n_params = sum(p.numel() for p in model.parameters())
        # card vs CPU from the same weights
        cpu = torch.device("cpu")
        model_c = copy.deepcopy(model).to(cpu)
        model.eval()
        model_c.eval()
        f_g = _fam_features(np.random.RandomState(1), FAM_AGREE, dev)
        f_c = type(f_g)(*(t.cpu() for t in f_g))
        with torch.inference_mode():
            res = {"gpu": {"cap": model.sample_beam(f_g, beam_size=FAM_BEAM)},
                   "cpu": {"cap": model_c.sample_beam(f_c,
                                                      beam_size=FAM_BEAM)}}
            zh = res["cpu"]["cap"].seq[:, 0]
            seq = torch.cat([torch.zeros((FAM_AGREE, 1), dtype=torch.long),
                             zh], 1)
            lp_g = model.forward(f_g, seq.to(dev))
            lp_c = model_c.forward(f_c, seq)
            if isinstance(lp_g, list):
                lp_g, lp_c = lp_g[-1], lp_c[-1]
            err = (lp_g.cpu() - lp_c).abs().max().item()
        del model_c
        log(f"families [{name}]: {n_params / 1e6:.2f} M parameters; card vs "
            f"cpu teacher-forced logprobs of {FAM_AGREE} images max|diff| "
            f"{err:.3g} (tol {AGREE_TOL})")
        if not err <= AGREE_TOL:
            raise AssertionError(f"families [{name}]: card and cpu disagree")
        zh_same = (res["gpu"]["cap"].seq[:, 0].cpu() == zh).float().mean()
        log(f"families [{name}]: zh top-beam tokens "
            f"{zh_same.item() * 100:.1f}% equal card vs cpu")
        walls["agreement"] = time.perf_counter() - t0

        # training: 2 XE steps and 1 SCST step on one batch; the XE loss
        # read without dropout before and after the two steps must fall
        model.train()
        batch = _fam_batch(np.random.RandomState(2))
        before = _fam_xe_loss(trainer, batch)
        t1 = time.perf_counter()
        xe = [trainer.train(batch) for _ in range(2)]
        torch.cuda.synchronize()
        walls["xe"] = (time.perf_counter() - t1) / 2
        after = _fam_xe_loss(trainer, batch)
        t1 = time.perf_counter()
        sc = trainer.train(batch, sc_flag=True)
        torch.cuda.synchronize()
        walls["scst"] = time.perf_counter() - t1
        losses = [o["total_loss"] for o in xe] + [sc["total_loss"]]
        log(f"families [{name}]: XE step losses {xe[0]['i2t_loss']:.4f}, "
            f"{xe[1]['i2t_loss']:.4f} (dropout on); XE loss without dropout "
            f"{before:.4f} before the steps, {after:.4f} after; SCST loss "
            f"{sc['i2t_loss']:.4f}, avg_reward {sc['avg_reward']:.4f}")
        # random weights sample words that rarely meet the references, so
        # the reward may be 0: the step must run and stay finite
        if not (all(np.isfinite(losses)) and after < before
                and np.isfinite(sc["avg_reward"])):
            raise AssertionError(f"families [{name}]: training {xe}, {sc}")

        # the beam-3 decode of FAM_IMAGES images
        model.eval()
        f50 = _fam_features(np.random.RandomState(3), FAM_IMAGES, dev)
        with torch.inference_mode():
            model.sample_beam(f50, beam_size=FAM_BEAM)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = model.sample_beam(f50, beam_size=FAM_BEAM)
            torch.cuda.synchronize()
        walls["beam"] = time.perf_counter() - t1
        if not (out.seq.shape == (FAM_IMAGES, FAM_BEAM, CAP["seq_length"])
                and torch.isfinite(out.scores).all()):
            raise AssertionError(f"families [{name}]: beam {out.seq.shape}")
    del trainer, model
    torch.cuda.empty_cache()
    walls["all"] = time.perf_counter() - t0
    log(f"families [{name}]: walls agreement {walls['agreement']:.2f} s, XE "
        f"step {walls['xe'] * 1e3:.1f} ms, SCST step "
        f"{walls['scst'] * 1e3:.1f} ms, beam {FAM_BEAM} over {FAM_IMAGES} "
        f"images {walls['beam'] * 1e3:.1f} ms; {walls['all']:.1f} s in all")
    return walls


def _fam_artifacts(root: str) -> dict:
    """FAM_SPLITS images of CAP's vocabulary (5 captions each, fc 2,048,
    att 196 x 2,048 `.npy` files) and the df cache of `prepro_ngrams`."""
    import os

    from unpaired_image_captioning_tpu_torch.data import synthetic
    from unpaired_image_captioning_tpu_torch.scripts import prepro_ngrams

    n_train, n_val, n_test = FAM_SPLITS
    jpath, label, mem = synthetic.make_caption_artifacts(
        root, n_images=n_train + n_val + n_test,
        vocab_size=CAP["vocab_size"], seq_length=CAP["seq_length"],
        caps_per_img=5, fc_dim=CAP["fc_feat_size"],
        att_dim=CAP["att_feat_size"], att_len=N_SLOTS, seed=1, n_val=n_val,
        n_test=n_test)
    fc_dir, att_dir = synthetic.write_feature_dirs(root, mem)
    ngrams = os.path.join(root, "ngrams.npz")
    with _quiet():
        prepro_ngrams.main(["--input_label_h5", label, "--input_json", jpath,
                            "--output", ngrams])
    return dict(input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
                input_att_dir=att_dir, cached_tokens=ngrams)


def _fam_recipe(files: dict, root: str, name: str, shapes: dict,
                totals: dict, resume: bool):
    """train.sh's XE -> SCST recipe for `name` through cli.train (FAM_RECIPE,
    then FAM_SCST with --start_from), each run's launches of B1 and B2 added
    to `totals`; with `resume`, the SCST stage once more stopped at its
    first epoch and resumed, whose state must equal the one-go stage's bit
    for bit. Returns the run dir and the walls."""
    import os
    import shutil

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk

    run = os.path.join(root, name)
    base = dict(FAM_RECIPE, caption_model=name,
                attri_feat_size=FAM["attri_feat_size"])
    walls = {}

    def cli(label, run_dir, **kw):
        lk.launches = tk.launches = 0
        with _recording_shapes(shapes):
            trainer, wall, ev = _recipe_run(files, run_dir,
                                            **dict(base, **kw))
        totals["lstm_cell"] += lk.launches
        totals["row_topk"] += tk.launches
        walls[label] = wall
        return trainer, ev

    _, ev_xe = cli("xe", run)
    if resume:
        # the XE stage's checkpoint, for the stopped-and-resumed twin
        twin = run + "_twin"
        shutil.copytree(run, twin)
    full, ev = cli("scst", run, start_from=run, **FAM_SCST)
    # the two stages append to one events.jsonl: XE steps, then SCST
    # exactly from the first step of epoch self_critical_after on
    steps = _steps(ev)
    xe_steps = [e for e in steps if "avg_reward" not in e]
    rl_steps = [e for e in steps if "avg_reward" in e]
    first = FAM_SCST["self_critical_after"]
    if not (xe_steps and rl_steps and steps[-len(rl_steps):] == rl_steps
            and xe_steps[-1]["step"] == len(_steps(ev_xe))
            and all(e["epoch"] >= first for e in rl_steps)
            and all(np.isfinite(e["total_loss"]) for e in steps)):
        raise AssertionError(f"{name} recipe: steps {steps}")
    with open(os.path.join(run, "histories.json")) as f:
        vals = json.load(f)["val_result_history"]
    evals = sorted(int(k) for k in vals)
    if not (any(k <= len(xe_steps) for k in evals)
            and any(k > len(xe_steps) for k in evals)
            and all(np.isfinite(list(v["lang_stats"].values())
                                + [v["loss"]]).all() for v in vals.values())):
        raise AssertionError(f"{name} recipe: evals {vals}")
    for n in ("model_i2t", "optimizer"):
        for best in ("", "-best"):
            if not os.path.exists(os.path.join(run, f"{n}{best}.pt")):
                raise AssertionError(f"{name} recipe: no {n}{best}.pt")
    log(f"families recipe [{name}]: evals after steps {evals}; XE losses "
        + ", ".join(f"{e['total_loss']:.4f}" for e in xe_steps)
        + "; SCST avg_reward "
        + ", ".join(f"{e['avg_reward']:.4f}" for e in rl_steps)
        + f"; step walls (ms) XE "
        + ", ".join(f"{e['step_time'] * 1e3:.1f}" for e in xe_steps)
        + ", SCST "
        + ", ".join(f"{e['step_time'] * 1e3:.1f}" for e in rl_steps)
        + f"; CLI walls XE {walls['xe']:.1f} s, SCST {walls['scst']:.1f} s")
    if resume:
        cli("scst stopped", twin, start_from=twin,
            **dict(FAM_SCST, max_epochs=FAM_SCST["max_epochs"] - 1))
        resumed, _ = cli("scst resumed", twin, start_from=twin, **FAM_SCST)
        _same_state(full, resumed, f"{name} recipe resume")
        log(f"families recipe [{name}]: the SCST stage stopped after its "
            "first epoch and resumed with --start_from equals the one-go "
            "stage bit for bit (parameters, Adam moments and counts); CLI "
            f"walls {walls['scst stopped']:.1f} s + "
            f"{walls['scst resumed']:.1f} s")
    return run, walls


def phase_families(dev) -> tuple:
    """The caption families of ROADMAP A10 on the card at CAP's widths
    (vocab 9,487, E = H = A = 512, fc and att 2,048, StackCap's attributes
    1,601):

    - B1 at every cell shape the families give it (FAMILY_CELLS x
      FAMILY_ROWS) against the plain cell, forward and backward, and B2
      at the beam-3 selections of 4 and 10 images, exact;
    - each of the 11 families (`_one_family`): card vs CPU teacher-forced
      logprobs, 2 XE steps and 1 SCST step of `Trainer.train`, a beam-3
      decode of 50 images;
    - train.sh's XE -> SCST recipe for fc (the SCST stage also stopped and
      resumed, bit for bit) and stackcap through cli.train, then
      `cli.eval_ensemble` over the two run dirs;
    - a use_bn 2 TopDown run dir through cli.train and `cli.eval_paired
      --bn_calibrate 2`, and one transformer use_bn 1 XE step at TCAP's
      widths (its running statistics move);
    - TopDown's beam-3 decode of 50 images with the four B9 flags on, held
      against the flags off.

    B1 and B2 are counted from 0 over the path and every shape the path
    gives them must be one the checks hold. Returns (their launches, the
    cells' records, the top-k records)."""
    import os
    import tempfile

    import torch

    from unpaired_image_captioning_tpu_torch.cli import (eval_ensemble,
                                                          eval_paired)
    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.models import att as am
    from unpaired_image_captioning_tpu_torch.models import setup
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    marks = []
    cells, topk = _family_cells(dev)
    marks.append(("kernel checks", time.perf_counter()))
    totals = {k: 0 for k in EVAL_KERNELS}
    shapes = {}

    # the families, each driven with B1 and B2 counted from 0
    walls = {}
    for name in FAMILIES:
        lk.launches = tk.launches = 0
        walls[name] = _one_family(dev, name, shapes)
        totals["lstm_cell"] += lk.launches
        totals["row_topk"] += tk.launches
        if not tk.launches or (name in ("fc", "topdown", "show_tell",
                                        "all_img", "show_attend_tell",
                                        "stackcap") and not lk.launches):
            raise AssertionError(f"families [{name}]: launches lstm_cell "
                                 f"{lk.launches}, row_topk {tk.launches}")
    marks.append(("11 families", time.perf_counter()))

    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="families-") as root:
        # language_eval writes its eval_results/ under the working directory
        os.chdir(root)
        try:
            files = _fam_artifacts(root)
            marks.append(("artifacts", time.perf_counter()))
            runs = {}
            for name in ("fc", "stackcap"):
                runs[name], _ = _fam_recipe(files, root, name, shapes,
                                            totals, resume=name == "fc")
            marks.append(("fc and stackcap recipes", time.perf_counter()))
            cli_runs = []
            ens = _run_cli("eval_ensemble (fc + stackcap, beam 3)",
                           eval_ensemble.main,
                           ["--ids", runs["fc"], runs["stackcap"],
                            "--batch_size", "10", "--beam_size", "3",
                            "--language_eval", "1"], totals, cli_runs, shapes)
            if len(ens["predictions"]) != FAM_SPLITS[2] or not np.isfinite(
                    ens["overall"]["CIDEr"]):
                raise AssertionError(f"eval_ensemble: {ens}")
            marks.append(("eval_ensemble", time.perf_counter()))

            # use_bn: a TopDown run dir, then eval_paired --bn_calibrate 2
            bn_run = os.path.join(root, "topdown_bn")
            lk.launches = tk.launches = 0
            with _recording_shapes(shapes):
                _, bn_wall, _ = _recipe_run(files, bn_run, **dict(
                    FAM_RECIPE, caption_model="topdown", use_bn=2,
                    max_epochs=1))
            totals["lstm_cell"] += lk.launches
            totals["row_topk"] += tk.launches
            seen = {}
            cal = am.calibrate_batch_norm

            def spy(model, loader, **kw):
                before = model.bn0.var.detach().clone()
                out = cal(model, loader, **kw)
                seen["moved"] = not torch.equal(before, model.bn0.var)
                seen["kw"] = kw
                return out

            am.calibrate_batch_norm = spy
            try:
                paired = _run_cli(
                    "eval_paired --bn_calibrate 2 (topdown use_bn 2)",
                    eval_paired.main,
                    _eval_argv(files, bn_run, beam_size=FAM_BEAM,
                               bn_calibrate=2, load_best_score=0,
                               language_eval=1),
                    totals, cli_runs, shapes)
            finally:
                am.calibrate_batch_norm = cal
            if not (seen.get("moved") and seen["kw"] == {"n_batches": 2}
                    and len(paired["predictions"]) == FAM_SPLITS[2]
                    and np.isfinite(paired["loss"])):
                raise AssertionError(f"eval_paired --bn_calibrate: {seen}, "
                                     f"{paired}")
            log(f"families: topdown use_bn 2 run dir (2 XE steps, an eval) "
                f"{bn_wall:.1f} s; eval_paired --bn_calibrate 2 recalibrated "
                f"bn0 / bn1 and decoded {len(paired['predictions'])} images,"
                f" loss {paired['loss']:.4f}, CIDEr "
                f"{paired['lang_stats']['CIDEr']:.4g}")
            marks.append(("use_bn run and eval_paired", time.perf_counter()))
        finally:
            os.chdir(here)

    # one transformer use_bn 1 XE step at TCAP's widths
    tr = Trainer(Config(**dict(TCAP, caption_model="transformer", use_bn=1,
                               batch_size=10, seq_per_img=5,
                               i2t_train_flag=True, seed=0,
                               dtype="float32")).finalize(),
                 device=dev)
    var0 = tr.i2t_model.bn0.var.detach().clone()
    out = tr.train(_fam_batch(np.random.RandomState(4)))
    moved = not torch.equal(var0, tr.i2t_model.bn0.var.detach())
    log(f"families: transformer use_bn 1 XE step, loss "
        f"{out['total_loss']:.4f}, running statistics moved: {moved}")
    if not (np.isfinite(out["total_loss"]) and moved):
        raise AssertionError("transformer use_bn step")
    del tr
    torch.cuda.empty_cache()
    marks.append(("transformer use_bn step", time.perf_counter()))

    # TopDown's beam-3 decode with the B9 flags on against off
    td = setup(Config(**dict(FAM, caption_model="topdown")),
               device=dev).init_params(torch.Generator().manual_seed(0))
    td.eval()
    f50 = _fam_features(np.random.RandomState(5), FAM_IMAGES, dev)
    res = {}
    for label, flags in (("off", {}), ("on", B9_FLAGS)):
        old = _att_flags(**flags)
        try:
            aak.beams_launches = 0
            lk.launches = tk.launches = 0
            with torch.inference_mode(), _recording_shapes(shapes):
                res[label] = td.sample_beam(f50, beam_size=FAM_BEAM)
                torch.cuda.synchronize()
            totals["lstm_cell"] += lk.launches
            totals["row_topk"] += tk.launches
            res[label + " beams"] = aak.beams_launches
        finally:
            _att_flags(**old)
    same = (res["on"].seq == res["off"].seq).all(-1).all(-1)
    gap = (res["on"].scores - res["off"].scores)[same].abs().max().item()
    steps = lk.launches // 2
    log(f"families: topdown beam {FAM_BEAM} over {FAM_IMAGES} images with "
        f"the B9 flags on ({res['on beams']} additive_attention_beams "
        f"launches in {steps} steps) against off: "
        f"{int(same.sum())} of {FAM_IMAGES} images' beams identical, their "
        f"scores max|diff| {gap:.3g} (tol {AGREE_TOL})")
    if not (res["on beams"] == steps and res["off beams"] == 0
            and int(same.sum()) >= FAM_IMAGES - 2 and gap <= AGREE_TOL):
        raise AssertionError("topdown with the B9 flags differs")
    del td
    torch.cuda.empty_cache()
    marks.append(("topdown B9 flags", time.perf_counter()))

    for name in ("lstm_cell", "row_topk"):
        if not totals[name]:
            raise AssertionError(f"families: {name} was not launched")
    held = _held_eval_shapes()
    held["lstm_cell"] |= {(b, d, h, m) for _, d, h, m in FAMILY_CELLS
                          for b in FAMILY_ROWS}
    held["row_topk"] |= {s[1:] for s in FAMILY_TOPK}
    for name in ("lstm_cell", "row_topk"):
        seen_shapes = shapes.get(name, set())
        log(f"families {name} shapes: {sorted(seen_shapes, key=str)}")
        unheld = _unheld(dev, name, seen_shapes, held[name])
        if unheld:
            raise AssertionError(
                f"families: {name} ran at {sorted(unheld, key=str)}, which "
                "no kernel check holds against the plain version")
    log("families walls (s): " + ", ".join(
        f"{n} {w['all']:.1f}" for n, w in walls.items()))
    log("families phase seconds: " + ", ".join(
        f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t) in zip(
            [("start", t_phase)] + marks, marks)))
    log(f"families launches: lstm_cell {totals['lstm_cell']}, row_topk "
        f"{totals['row_topk']}; phase {time.perf_counter() - t_phase:.1f} s")
    return ({k: totals[k] for k in ("lstm_cell", "row_topk")}, cells, topk)


# ---------------------------------------------------------------------------
# diverse beam groups and the NMT extras (ROADMAP A10, A11)
# ---------------------------------------------------------------------------

# the NMT extras on the LSTM pivot's NMT (NMT: src 11,986, tgt 8,571, 512
# wide, BiLSTM, beam 15, 20 steps), each variant a fresh model from seed 0
NMTX_VARIANTS = [
    ("a: copy attention, context gate both, coverage, positional encoding, "
     "shared decoder embeddings",
     dict(copy_attn=True, context_gate="both", coverage_attn=True,
          position_encoding=True, share_decoder_embeddings=True)),
    ("b: constrained_softmax, c_attn 0.2, predicted fertility, source "
     "features of 50 and 8 values",
     dict(attn_transform="constrained_softmax", c_attn=0.2,
          predict_fertility=True, src_feature_sizes=(50, 8),
          feature_vec_size=100)),
    ("c: constrained_sparsemax with guided fertility, mlp attention, no "
     "input feed, coverage feedback",
     dict(attn_transform="constrained_sparsemax", attention_type="mlp",
          input_feed=0, coverage_attn=True, coverage_feed=True)),
    ("d: sparsemax", dict(attn_transform="sparsemax")),
]
NMTX_AGREE = 4          # sentences decoded card vs CPU
NMTX_LINES = 100        # seeded lines through cli.translate
NMTX_EVAL_IMAGES = 10   # images through eval_split_coco_unpaired
NMTX_SHARED = 2000      # source words whose label the target dict shares
# diverse beam groups: (family, beam, groups) at lambda 0.5
DIVERSE = [("denseatt", 6, 3), ("transformer", 4, 2)]
DIVERSE_LAMBDA = 0.5
# the extended copy vocab: the target's plus one slot a source position
# (16: the pivot's caption length, and the longest seeded line)
EXT_V = NMT["tgt_vocab_size"] + NMT_SRC_LEN
# (label, D, H, maxout, rows): the cells the phase gives B1 (the NMT's at
# its agreement batches 2 and 4, batch 50, beam 15 over 4 and 50
# sentences; NMTImageEncoder's; denseatt's diverse beams over 4 and 50
# images)
NMTX_CELLS = [
    ("nmt encoder, per direction", 512, 256, False, (2, 4, 50)),
    ("nmt decoder, input feed", 1024, 512, False, (2, 4, 50, 60, 750)),
    ("nmt decoder, no input feed", 512, 512, False, (2, 4, 50, 60, 750)),
    ("NMTImageEncoder, per direction", 2048, 256, False, (16,)),
    ("denseatt lstm0/1/2, diverse beam 6", 1024, 512, True, (24, 300)),
]
NMTX_TIMED_CELLS = {(50, 512, 512), (750, 512, 512), (16, 2048, 256),
                    (300, 1024, 512)}
# (label, R, V, k): the grouped selections (bd = 2 beams x 9,488 a row of
# an image) and the extended vocab's rows
NMTX_TOPK = [
    ("diverse groups, 2 x 9,488 over 50 images", 50, 2 * 9488, 2),
    ("diverse groups, 2 x 9,488 over 4 images", 4, 2 * 9488, 2),
    ("extended copy vocab, beam 15 x 50", 750, EXT_V, 15),
    ("extended copy vocab, beam 15 x 10", 150, EXT_V, 15),
    ("extended copy vocab, beam 15 x 4", 60, EXT_V, 15),
]
NMTX_TIMED_TOPK = {(50, 2 * 9488, 2), (750, EXT_V, 15)}
NMTX_IMAGE_GRID = (16, 14, 14, 2048)
# the output layer's scale in the beams held token for token card vs CPU:
# random full-width weights leave the best candidates of a step within f32
# noise of each other (run 1 of PR 19: denseatt's diverse beams on 4 images
# parted there), so the held decodes use the model with its output weights
# times AGREE_SHARPEN, whose choices stand far above that noise; the model
# as drawn is compared too, for information
AGREE_SHARPEN = 30.0


def _group_rows(x, k: int) -> None:
    """The beam rows of `_few_beam_rows` where x has 12 rows or more; else
    exact ties, a row whose second half is a masked beam (-1e10, a group's
    local step 0), an all -inf row."""
    if x.shape[0] >= 12:
        _few_beam_rows(x, k)
        return
    x[0] = (x[0] * 2).round() / 2
    x[1, x.shape[1] // 2:] = -1e10
    x[2] = float("-inf")


def _nmtx_dicts():
    """Seeded source and target dicts at NMT's sizes: source words zh1 ..,
    target words en.., the first NMTX_SHARED source labels shared by the
    target dict (Dict.align maps them; the others copy through the
    extended vocab)."""
    from unpaired_image_captioning_tpu_torch import constants as C
    from unpaired_image_captioning_tpu_torch.vocab import Dict

    specials = [C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
    src = Dict(specials + [f"zh{i}" for i in range(
        1, NMT["src_vocab_size"] - 3)])
    tgt = Dict(specials + [f"zh{i}" if i <= NMTX_SHARED else f"en{i}"
                           for i in range(1, NMT["tgt_vocab_size"] - 3)])
    return src, tgt


def _sharpen(model) -> None:
    """Scale `model`'s output weights by AGREE_SHARPEN in place (the
    captioners' logit layer, the NMT's generator or, shared, its target
    table)."""
    import torch

    with torch.no_grad():
        if hasattr(model, "logit"):
            model.logit[-1].w.mul_(AGREE_SHARPEN)
        elif getattr(model, "share_decoder_embeddings", False):
            model.tgt_embedding().mul_(AGREE_SHARPEN)
        else:
            model.generator.w.mul_(AGREE_SHARPEN)


def _beams_agree(got, want) -> tuple:
    """(tokens identical, scores max|diff| / max(1, max|score|)) of a card
    and a CPU BeamResult, and a note on the first differing token."""
    import torch

    gs, ws = got.seq.cpu(), want.seq
    same = torch.equal(gs, ws)
    gsc = got.scores.cpu()
    err = ((gsc - want.scores).abs().max().item()
           / max(1.0, want.scores.abs().max().item()))
    note = ""
    if not same:
        b, k, t = (int(v) for v in (gs != ws).nonzero()[0])
        note = (f"; first difference image {b} beam {k} step {t}: "
                f"{int(gs[b, k, t])} vs {int(ws[b, k, t])}, per-token "
                f"logprob {got.logps[b, k, t].item():.6g} vs "
                f"{want.logps[b, k, t].item():.6g}")
    return same, err, note


def _nmtx_diverse(dev, cap_dense) -> dict:
    """Diverse beam groups on the denseatt (CAP, beam 6 in 3 groups) and
    the transformer captioner (TCAP, beam 4 in 2 groups) at lambda 0.5: one
    batch-50 call each on the card (timed), and 4 images card vs CPU with
    the output layer sharpened (AGREE_SHARPEN): tokens identical and
    scores within TRAIN_TOL * max(1, max|score|). Returns the walls
    (ms)."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.models.transformer import (
        TransformerModel)

    walls = {}
    for name, beam, groups in DIVERSE:
        if name == "denseatt":
            card = cap_dense
            cpu = type(card)(**CAP, device="cpu")
            cpu.load_state_dict(card.state_dict())
        else:
            cpu = TransformerModel(**TCAP, device="cpu").init_params(
                torch.Generator().manual_seed(0))
            card = TransformerModel(**TCAP, device=dev)
            card.load_state_dict(cpu.state_dict())
        cpu.eval()
        card.eval()
        fc, att = make_features(np.random.RandomState(19), BENCH_BATCH)

        def feats(n, device):
            return Features(fc_feats=torch.from_numpy(fc[:n]).to(device),
                            att_feats=torch.from_numpy(att[:n]).to(device))

        kw = dict(beam_size=beam, group_size=groups,
                  diversity_lambda=DIVERSE_LAMBDA)
        with torch.inference_mode():
            f50 = feats(BENCH_BATCH, dev)
            card.sample_beam(f50, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = card.sample_beam(f50, **kw)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
            drawn = _beams_agree(
                card.sample_beam(feats(NMTX_AGREE, dev), **kw),
                cpu.sample_beam(feats(NMTX_AGREE, "cpu"), **kw))
            drawn_w = card.state_dict()
            for m in (card, cpu):
                _sharpen(m)
            same, err, note = _beams_agree(
                card.sample_beam(feats(NMTX_AGREE, dev), **kw),
                cpu.sample_beam(feats(NMTX_AGREE, "cpu"), **kw))
            card.load_state_dict({k: v.clone() for k, v in drawn_w.items()})
        bd = beam // groups
        first = res.seq[:, ::bd, 0]                   # each group's best
        split = int((first != first[:, :1]).any(1).sum())
        log(f"diverse beams [{name}, beam {beam} in {groups} groups, lambda "
            f"{DIVERSE_LAMBDA}]: batch {BENCH_BATCH} host wall "
            f"{walls[name]:.1f} ms ({len(res.seq[0, 0])} steps + "
            f"{groups - 1} stagger); {split} of {BENCH_BATCH} images' groups "
            f"start on different words; {NMTX_AGREE} images card vs cpu, "
            f"output x{AGREE_SHARPEN:g}: tokens identical {same}, scores "
            f"max|diff| / max(1, max|score|) {err:.3g} (tol {TRAIN_TOL})"
            f"{note}; as drawn (information): tokens identical {drawn[0]}, "
            f"scores {drawn[1]:.3g}{drawn[2]}")
        if not (same and err <= TRAIN_TOL and split
                and torch.isfinite(res.scores).all()):
            raise AssertionError(f"diverse beams [{name}] on the card")
        if name != "denseatt":
            del card
        del cpu
    torch.cuda.empty_cache()
    return walls


def _nmtx_inputs(rs, opts: dict, n: int) -> dict:
    """An NMT batch of `n` sentences (`make_nmt_batch`), with the source
    features the variant takes (random values, PAD at PAD) and, for the
    guided variant, the fertility of each source position from a table that
    `utils/fertility` folds from seeded alignment lines."""
    from unpaired_image_captioning_tpu_torch.utils import fertility

    nb = make_nmt_batch(rs, n)["nmt"]
    src = nb["src"]
    extra = {}
    if opts.get("src_feature_sizes"):
        feats = np.stack([rs.randint(1, m, src.shape) for m in
                          opts["src_feature_sizes"]], -1)
        feats[src == 0] = 0
        extra["src_feats"] = feats
    if opts.get("attn_transform") == "constrained_sparsemax":
        lines = [" ".join(f"{rs.randint(0, l)}-{j}" for j in range(
            rs.randint(1, l + 1))) for l in nb["lengths"]]
        table = fertility.alignment_fertilities(
            lines, [list(r[:l]) for r, l in zip(src, nb["lengths"])],
            NMT["src_vocab_size"])
        extra["src_fertilities"] = fertility.batch_fertilities(table, src)
    return dict(nb, **extra)


def _nmtx_variant(dev, label: str, opts: dict, s2t) -> float:
    """One NMT variant on the card: teacher-forced logprobs of NMTX_AGREE
    sentences and their beam-15 translation card vs CPU (within AGREE_TOL;
    tokens identical), a timed batch-50 translation at beam 15, one
    `Trainer.train` step card vs CPU on 2 sentences (`_step_agreement`;
    variant b's batch carries its features) and one on the card at batch
    50. Returns the batch-50 translation's host wall (ms)."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    cpu = NMTModel(**NMT, **opts, device="cpu").init_params(
        torch.Generator().manual_seed(0)).eval()
    card = NMTModel(**NMT, **opts, device=dev)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    batch = _nmtx_inputs(np.random.RandomState(21), opts, BENCH_BATCH)
    copy = {"src2tgt": s2t} if opts.get("copy_attn") else {}

    def up(n, device):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v[:n]))
            out[k] = (t.float() if t.is_floating_point() else t.long()).to(
                device)
        return out

    def extra(b):
        return {k: b[k] for k in ("src_feats", "src_fertilities") if k in b}

    res = {}
    with torch.inference_mode():
        for name, model, device in (("gpu", card, dev), ("cpu", cpu, "cpu")):
            b = up(NMTX_AGREE, device)
            outs = model.forward(b["src"], b["lengths"], b["tgt"],
                                 **extra(b))[0]
            lp = torch.log_softmax(model.generator_logits(outs), -1)
            res[name] = [lp.cpu(), model.translate_batch(
                b["src"], b["lengths"], **copy, **extra(b))]
        drawn = _beams_agree(res["gpu"][1], res["cpu"][1])
        b = up(BENCH_BATCH, dev)
        card.translate_batch(b["src"], b["lengths"], **copy, **extra(b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = card.translate_batch(b["src"], b["lengths"], **copy, **extra(b))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for name, model, device in (("gpu", card, dev), ("cpu", cpu, "cpu")):
            b = up(NMTX_AGREE, device)
            _sharpen(model)
            res[name][1] = model.translate_batch(b["src"], b["lengths"],
                                                 **copy, **extra(b))
    lp_err = (res["gpu"][0] - res["cpu"][0]).abs().max().item()
    same, err, note = _beams_agree(res["gpu"][1], res["cpu"][1])
    copies = int((tr.seq >= NMT["tgt_vocab_size"]).sum())
    log(f"nmt extras [{label}]: {NMTX_AGREE} sentences card vs cpu: "
        f"teacher-forced logprobs max|diff| {lp_err:.3g} (tol {AGREE_TOL}); "
        f"beam {NMT_BEAM}, output x{AGREE_SHARPEN:g}: tokens identical "
        f"{same}, scores max|diff| / max(1, max|score|) {err:.3g} (tol "
        f"{TRAIN_TOL}){note}; as drawn (information): tokens identical "
        f"{drawn[0]}, scores {drawn[1]:.3g}{drawn[2]}; batch {BENCH_BATCH} "
        f"beam {NMT_BEAM} host wall {wall:.1f} ms"
        + (f", {copies} exact-copy tokens" if copy else ""))
    if not (lp_err <= AGREE_TOL and same and err <= TRAIN_TOL
            and torch.isfinite(tr.scores).all()):
        raise AssertionError(f"nmt extras [{label}] card vs cpu")
    del card, cpu
    cfg_opts = {("nmt_src_feature_sizes" if k == "src_feature_sizes"
                 else k): v for k, v in opts.items()}
    cfg = dict(NMT_TRAIN, **cfg_opts, batch_size=2, dropout=0.0,
               nmt_optim="sgd", nmt_learning_rate=1.0)
    host = {k: np.asarray(v) for k, v in batch.items()
            if k != "src_fertilities"}
    _step_agreement(dev, cfg, {"nmt": {k: v[:2] for k, v in host.items()}},
                    {}, f"nmt extras {label[:1]}")
    tr = Trainer(Config(**dict(cfg, batch_size=BENCH_BATCH)), device=dev)
    out = tr.train({"nmt": host})
    if not np.isfinite(out["total_loss"]):
        raise AssertionError(f"nmt extras [{label}]: batch-50 step {out}")
    del tr
    torch.cuda.empty_cache()
    return wall


def _nmtx_image_encoder(dev) -> None:
    """NMTImageEncoder (feat 2,048 -> rnn 512) on a [16, 14, 14, 2,048]
    grid, card vs CPU within TRAIN_TOL * max(1, max|ctx|)."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.nmt import (
        NMTImageEncoder)

    cpu = NMTImageEncoder(feat_size=2048, rnn_size=512,
                          device="cpu").init_params(
        torch.Generator().manual_seed(0))
    card = NMTImageEncoder(feat_size=2048, rnn_size=512, device=dev)
    card.load_state_dict(cpu.state_dict())
    grid = torch.from_numpy(np.random.RandomState(23).randn(
        *NMTX_IMAGE_GRID).astype(np.float32))
    with torch.inference_mode():
        want, (wh, _) = cpu.apply(grid)
        got, (gh, _) = card.apply(grid.to(dev))
    err = max((got.cpu() - want).abs().max().item(),
              (gh.cpu() - wh).abs().max().item()) / max(
        1.0, want.abs().max().item())
    log(f"NMTImageEncoder {list(NMTX_IMAGE_GRID)} -> context "
        f"{list(got.shape)}: card vs cpu max|diff| / max(1, max|ctx|) "
        f"{err:.3g} (tol {TRAIN_TOL})")
    if not err <= TRAIN_TOL:
        raise AssertionError("NMTImageEncoder card vs cpu")


class _NmtxLoader:
    """The caption loader's interface for `eval_split_coco_unpaired`: the
    test split of NMTX_EVAL_IMAGES seeded images in one batch."""

    seq_per_img = 1

    def __init__(self, zh_vocab: dict):
        fc, att = make_features(np.random.RandomState(29),
                                NMTX_EVAL_IMAGES)
        self.vocab = types.SimpleNamespace(ix_to_word=zh_vocab)
        self.split_ix = {"test": list(range(NMTX_EVAL_IMAGES))}
        self.batch = {"fc_feats": fc, "att_feats": att,
                      "attri_feats": np.zeros((NMTX_EVAL_IMAGES, 1),
                                              np.float32),
                      "att_masks": np.ones((NMTX_EVAL_IMAGES, N_SLOTS),
                                           np.float32),
                      "infos": [{"id": i} for i in range(NMTX_EVAL_IMAGES)],
                      "bounds": {"wrapped": True}}

    def reset_iterator(self, split):
        pass

    def get_batch(self, split):
        return self.batch


def _nmtx_copy_paths(dev, cap_dense, s2t, src_dict, tgt_dict) -> dict:
    """The copy model (variant a) behind the pivot and the CLIs:
    `pivot_translate` with `src2tgt` at batch 50 beside the plain LSTM
    pivot's NMT (images/s of each), `eval_split_coco_unpaired(src2tgt=)` on
    NMTX_EVAL_IMAGES images (every en caption non-empty, exact copies
    resolved to zh words), and `cli.translate -copy_mode extended` and
    `fold` on NMTX_LINES seeded lines of a run dir written for it. Returns
    the pivots' images/s."""
    import os
    import tempfile

    import torch

    from unpaired_image_captioning_tpu_torch.cli import translate
    from unpaired_image_captioning_tpu_torch.eval.eval_utils import (
        eval_split_coco_unpaired)
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
    from unpaired_image_captioning_tpu_torch.pivot import (
        captions_to_nmt_batch, pivot_translate)
    from unpaired_image_captioning_tpu_torch.train.checkpoint import (
        save_json, save_state)

    copy_nmt = NMTModel(**NMT, **NMTX_VARIANTS[0][1], device=dev)
    copy_nmt.init_params(torch.Generator().manual_seed(0)).eval()
    plain_nmt = NMTModel(**NMT, device=dev).init_params(
        torch.Generator().manual_seed(0)).eval()
    cap2nmt = torch.from_numpy(_cap2nmt()).to(dev)
    fc, att = make_features(np.random.RandomState(31), BENCH_BATCH)
    feats = Features(fc_feats=torch.from_numpy(fc).to(dev),
                     att_feats=torch.from_numpy(att).to(dev))
    s2t_dev = torch.from_numpy(s2t).long().to(dev)
    ips = {}
    for name, nmt, kw in (("copy", copy_nmt, {"src2tgt": s2t_dev}),
                          ("plain", plain_nmt, {})):
        with torch.inference_mode():
            pivot_translate(cap_dense, nmt, feats, cap2nmt, **kw,
                            nmt_max_len=NMT_MAX_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            zh, en, aux = pivot_translate(cap_dense, nmt, feats, cap2nmt,
                                          **kw, nmt_max_len=NMT_MAX_LEN)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ips[name] = BENCH_BATCH / wall
        n_copy = 0
        if kw:
            # the exact copies the extended beam chose, before the pivot
            # folded them into UNK + source position
            with torch.inference_mode():
                src, lengths = captions_to_nmt_batch(zh, cap2nmt)
                raw = nmt.translate_batch(src, lengths, src2tgt=s2t_dev,
                                          max_len=NMT_MAX_LEN).seq[:, 0]
            ext = raw >= NMT["tgt_vocab_size"]
            n_copy = int(ext.sum())
            if not (n_copy and torch.equal(en[ext], torch.ones_like(
                    en[ext])) and torch.equal(
                    aux[ext], raw[ext] - NMT["tgt_vocab_size"])):
                raise AssertionError("pivot_translate: exact copies not "
                                     "resolved to UNK + source position")
        log(f"pivot_translate [{name} NMT, caption beam {CAP_BEAM} -> NMT "
            f"beam {NMT_BEAM}, batch {BENCH_BATCH}]: {wall * 1e3:.1f} ms, "
            f"{ips[name]:.1f} images/s"
            + (f"; {n_copy} exact copies resolved to their source positions"
               if kw else ""))
        if not bool((en < NMT["tgt_vocab_size"]).all()):
            raise AssertionError(f"pivot_translate [{name}]: ids past the "
                                 "vocab after resolve_extended")
    del plain_nmt
    zh_vocab = {str(i): f"zh{i}" for i in range(1, CAP["vocab_size"] + 1)}
    tgt_itos = {int(k): v for k, v in tgt_dict.idx_to_label.items()}
    out = eval_split_coco_unpaired(cap_dense, copy_nmt,
                                   _NmtxLoader(zh_vocab), _cap2nmt(),
                                   tgt_itos, split="test", src2tgt=s2t,
                                   nmt_max_len=NMT_MAX_LEN)
    caps = [p["caption"] for p in out["en_predictions"]]
    # zh caption words in the en captions: UNK replaced by the exact copy's
    # source word (or the attention's, where the beam chose UNK itself)
    copied = sum(w.startswith("zh") for c in caps for w in c.split())
    log(f"eval_split_coco_unpaired(src2tgt=...) on {len(caps)} images: "
        f"{sum(bool(c) for c in caps)} non-empty en captions, {copied} zh "
        f"words copied into them; first: {caps[0][:80]!r}")
    if not (len(caps) == NMTX_EVAL_IMAGES and all(caps) and copied):
        raise AssertionError("eval_split_coco_unpaired with src2tgt")
    with tempfile.TemporaryDirectory(prefix="nmtx-") as run:
        args = dict(copy_nmt.init_args, model_type="rnn")
        save_json(os.path.join(run, "nmt_config.json"), args)
        save_state(os.path.join(run, "model_nmt.pt"), copy_nmt.state_dict())
        for side, d in (("src", src_dict), ("tgt", tgt_dict)):
            save_json(os.path.join(run, f"{side}_dict.json"), d.state_dict())
        rs = np.random.RandomState(37)
        lens = rs.randint(4, NMT_SRC_LEN + 1, NMTX_LINES)
        lens[0] = NMT_SRC_LEN
        lines = [" ".join(f"zh{w}" for w in rs.randint(
            1, NMT["src_vocab_size"] - 4, n)) for n in lens]
        with open(os.path.join(run, "zh.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        for mode in ("extended", "fold"):
            path = os.path.join(run, f"en_{mode}.txt")
            t0 = time.perf_counter()
            with _quiet():
                translate.main(["-model", run, "-src",
                                os.path.join(run, "zh.txt"), "-output", path,
                                "-batch_size", str(BENCH_BATCH),
                                "-max_sent_length", str(NMT_MAX_LEN),
                                "-copy_mode", mode])
            wall = time.perf_counter() - t0
            with open(path) as f:
                got = f.read().splitlines()
            n_zh = sum(w.startswith("zh") for l in got for w in l.split())
            log(f"cli.translate -copy_mode {mode} on {NMTX_LINES} lines: "
                f"{wall:.2f} s, {sum(bool(l) for l in got)} non-empty, "
                f"{n_zh} zh words copied")
            if len(got) != NMTX_LINES or not n_zh:
                raise AssertionError(f"cli.translate -copy_mode {mode}")
    del copy_nmt
    torch.cuda.empty_cache()
    return ips


def phase_nmt_extras(dev) -> tuple:
    """Diverse beam groups and the NMT extras of ROADMAP A10 / A11 on the
    card at full width:

    - B1 at every cell shape the phase gives it (NMTX_CELLS) against the
      plain cell, forward and backward, and B2 at the grouped and the
      extended-vocab rows (NMTX_TOPK), exact (B4 at the transformer's
      diverse beams is among TFD_SHAPES);
    - diverse groups on both captioners (`_nmtx_diverse`);
    - the four NMT variants (`_nmtx_variant`), NMTImageEncoder, and the
      copy model behind `pivot_translate`, `eval_split_coco_unpaired` and
      `cli.translate` (`_nmtx_copy_paths`).

    B1, B2 and B4 are counted from 0 over the path, and every shape the
    path gives them must be one the checks hold. Returns (their launches,
    the cells' records, the top-k records)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models.att import DenseAttModel

    t_phase = time.perf_counter()
    cells, topk = _family_cells(dev, NMTX_CELLS, NMTX_TOPK,
                                timed=NMTX_TIMED_CELLS,
                                topk_timed=NMTX_TIMED_TOPK,
                                special=_group_rows, seed=19)
    t_checks = time.perf_counter()
    src_dict, tgt_dict = _nmtx_dicts()
    s2t = src_dict.align(tgt_dict)
    cap = DenseAttModel(**CAP, device=dev).init_params(
        torch.Generator().manual_seed(0)).eval()
    shapes = {}
    lk.launches = tk.launches = tdk.stack_launches = 0
    with _recording_shapes(shapes):
        walls = _nmtx_diverse(dev, cap)
        t_div = time.perf_counter()
        for label, opts in NMTX_VARIANTS:
            walls[label[:1]] = _nmtx_variant(dev, label, opts, s2t)
        t_var = time.perf_counter()
        _nmtx_image_encoder(dev)
        ips = _nmtx_copy_paths(dev, cap, s2t, src_dict, tgt_dict)
        torch.cuda.synchronize()
    counts = {"lstm_cell": lk.launches, "row_topk": tk.launches,
              "transformer_decode_stack": tdk.stack_launches}
    del cap
    torch.cuda.empty_cache()
    if not all(counts.values()):
        raise AssertionError(f"nmt extras: a kernel of the path was not "
                             f"launched: {counts}")
    held = _held_eval_shapes()
    held["lstm_cell"] |= {(b, d, h, m) for _, d, h, m, rows in NMTX_CELLS
                          for b in rows}
    held["row_topk"] |= {s[1:] for s in NMTX_TOPK}
    for name in ("lstm_cell", "row_topk", "transformer_decode_stack"):
        seen = shapes.get(name, set())
        log(f"nmt extras {name} shapes: {sorted(seen, key=str)}")
        unheld = _unheld(dev, name, seen, held[name])
        if unheld:
            raise AssertionError(
                f"nmt extras: {name} ran at {sorted(unheld, key=str)}, which "
                "no kernel check holds against the plain version")
    end = time.perf_counter()
    log(f"nmt extras: host walls (ms) " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; pivot images/s copy {ips['copy']:.1f}, plain "
        f"{ips['plain']:.1f}; launches {counts}; phase seconds: checks "
        f"{t_checks - t_phase:.1f}, diverse {t_div - t_checks:.1f}, "
        f"variants {t_var - t_div:.1f}, image encoder and copy paths "
        f"{end - t_var:.1f}; all {end - t_phase:.1f}")
    return counts, cells, topk


# ---------------------------------------------------------------------------
# the fork's post-norm transformer (ROADMAP A12)
# ---------------------------------------------------------------------------

# the fork's transformer at full width on the NMT's vocabularies
FORK = dict(d_model=512, d_inner=2048, num_layers=6, num_heads=8)
FORK_SENTS, FORK_SRC_LEN, FORK_TGT_LEN = 50, 20, 20
FORK_MAX_LEN = 50     # translate_greedy's max_len
FORK_AGREE = 4        # sentences greedy-decoded card vs CPU
CARD = []             # nvidia-smi's "name, power.limit" (phase_device)


def make_fork_state_dict(seed: int = 0) -> dict:
    """A fork checkpoint's state dict (the `-encoder_layer transformer
    -decoder_layer transformer` layout `convert_fork_transformer` reads) at
    FORK's widths and NMT's vocabularies, seeded: weights normal / sqrt(in),
    embeddings normal x 0.1, LayerNorm gains 1 and biases 0."""
    rs = np.random.RandomState(seed)
    d, f = FORK["d_model"], FORK["d_inner"]

    def w(out, inp):
        return (rs.randn(out, inp) / inp ** 0.5).astype(np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    state = {
        "encoder.embeddings.word_lut.weight": (rs.randn(
            NMT["src_vocab_size"], d) * 0.1).astype(np.float32),
        "decoder.embeddings.word_lut.weight": (rs.randn(
            NMT["tgt_vocab_size"], d) * 0.1).astype(np.float32),
        "generator.0.weight": w(NMT["tgt_vocab_size"], d),
        "generator.0.bias": zeros(NMT["tgt_vocab_size"])}
    for side, atts in (("encoder", ("self_attn",)),
                       ("decoder", ("self_attn", "context_attn"))):
        for i in range(FORK["num_layers"]):
            p = f"{side}.transformer.{i}"
            for a in atts:
                for n in ("query", "keys", "values"):
                    state[f"{p}.{a}.linear_{n}.weight"] = w(d, d)
                state[f"{p}.{a}.layer_norm.a_2"] = np.ones((d,), np.float32)
                state[f"{p}.{a}.layer_norm.b_2"] = zeros(d)
            ff = f"{p}.feed_forward"
            state[f"{ff}.w_1.weight"], state[f"{ff}.w_1.bias"] = w(f, d), \
                zeros(f)
            state[f"{ff}.w_2.weight"], state[f"{ff}.w_2.bias"] = w(d, f), \
                zeros(d)
            state[f"{ff}.layer_norm.a_2"] = np.ones((d,), np.float32)
            state[f"{ff}.layer_norm.b_2"] = zeros(d)
    return state


def phase_fork_transformer(dev) -> None:
    """The fork's post-norm transformer (`models/fork_transformer.py`) at
    FORK's widths, loaded through `convert_fork_transformer` from a seeded
    fork state dict, on the card and on the CPU: teacher-forced logprobs
    of FORK_SENTS sentences of FORK_SRC_LEN words (some PAD-padded) within
    AGREE_TOL, then `translate_greedy` to FORK_MAX_LEN with the generator
    sharpened (AGREE_SHARPEN) token-identical on FORK_AGREE sentences, and
    the card's greedy sentences/s on all FORK_SENTS. The model is plain
    torch, as XLA computes it in JAX: no kernel of the port serves it."""
    import torch

    from unpaired_image_captioning_tpu_torch.models.fork_transformer import (
        ForkTransformerNMT)

    t0 = time.perf_counter()
    state = make_fork_state_dict(0)
    models = {d: ForkTransformerNMT.from_fork_state_dict(
        state, num_heads=FORK["num_heads"], device=d).eval()
        for d in (dev, "cpu")}
    del state
    card, cpu = models[dev], models["cpu"]
    if (card.num_layers, card.d_model, card.d_inner) != (
            FORK["num_layers"], FORK["d_model"], FORK["d_inner"]):
        raise AssertionError("fork transformer: the widths read from the "
                             "state dict are not FORK's")
    rs = np.random.RandomState(21)
    src = rs.randint(4, NMT["src_vocab_size"], (FORK_SENTS, FORK_SRC_LEN))
    lengths = rs.randint(8, FORK_SRC_LEN + 1, FORK_SENTS)
    lengths[0] = FORK_SRC_LEN
    src[np.arange(FORK_SRC_LEN)[None, :] >= lengths[:, None]] = 0
    tgt = rs.randint(4, NMT["tgt_vocab_size"], (FORK_SENTS, FORK_TGT_LEN))
    tgt[:, 0] = NMT_BOS
    src_t, tgt_t = torch.from_numpy(src), torch.from_numpy(tgt)
    with torch.no_grad():
        lp_card, attn_card = card(src_t.to(dev), tgt_t.to(dev))
        lp_cpu, attn_cpu = cpu(src_t, tgt_t)
    err = max((lp_card.cpu() - lp_cpu).abs().max().item(),
              (attn_card.cpu() - attn_cpu).abs().max().item())
    if not (err <= AGREE_TOL and torch.isfinite(lp_card).all()):
        raise AssertionError(f"fork transformer: teacher-forced logprobs or "
                             f"attention card vs CPU max|diff| {err} > "
                             f"{AGREE_TOL}")
    with torch.no_grad():
        for m in (card, cpu):
            m.generator.w.mul_(AGREE_SHARPEN)
    few = src_t[:FORK_AGREE]
    got = card.translate_greedy(few.to(dev), max_len=FORK_MAX_LEN).cpu()
    want = cpu.translate_greedy(few, max_len=FORK_MAX_LEN)
    if not torch.equal(got, want):
        raise AssertionError(f"fork transformer: greedy tokens card vs CPU "
                             f"differ: {got.tolist()} vs {want.tolist()}")
    card.translate_greedy(few.to(dev), max_len=FORK_MAX_LEN)   # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = card.translate_greedy(src_t.to(dev), max_len=FORK_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if out.shape != (FORK_SENTS, FORK_MAX_LEN - 1):
        raise AssertionError(f"fork transformer: greedy output {out.shape}")
    ended = int((out == NMT_EOS).any(1).sum())
    del models, card, cpu
    torch.cuda.empty_cache()
    log(f"fork transformer (d {FORK['d_model']}, d_inner {FORK['d_inner']}, "
        f"{FORK['num_layers']} + {FORK['num_layers']} layers, "
        f"{FORK['num_heads']} heads, vocabularies {NMT['src_vocab_size']} / "
        f"{NMT['tgt_vocab_size']}): teacher-forced logprobs and attention of "
        f"{FORK_SENTS} x {FORK_SRC_LEN} card vs CPU max|diff| {err:.3g} (tol "
        f"{AGREE_TOL}); greedy to {FORK_MAX_LEN} of {FORK_AGREE} sentences "
        f"token-identical (generator x {AGREE_SHARPEN:g}); "
        f"{FORK_SENTS} sentences greedy in {wall * 1e3:.1f} ms = "
        f"{FORK_SENTS / wall:.1f} sentences/s ({ended} ended in EOS) on "
        f"{CARD[0] if CARD else 'the card'}; plain torch, no kernel; phase "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# scale-out on torch.distributed (ROADMAP A14)
# ---------------------------------------------------------------------------

# the joint recipe's step at its global batch (50 images x 5 captions, the
# NMT's 50 pairs), dropout off and SGD with momentum (linear in the
# gradient, so sums in another order stay far below the tolerance; Adam
# would divide near-zero gradients by their own noise)
SCALE_TRAIN = dict(JOINT_TRAIN, drop_prob_lm=0.0, dropout=0.0, seq_per_img=5,
                   i2t_optim="sgdm", i2t_learning_rate=1e-2,
                   nmt_optim="sgdm", nmt_learning_rate=1e-2,
                   nmt_max_grad_norm=5.0, nmt_kld_train_flag=False)
SCALE_IMAGES, SCALE_CAPS = 50, 5
SCALE_DF_IMAGES = 300   # the df table's corpus (the first 50 are the gts)
SCALE_TOL = 1e-5        # losses and parameters, N ranks vs the card's one
SCALE_KERNELS = ("lstm_cell", "row_topk", "additive_attention")
# the transformer NMT's step at bench width (TNMT_TRAIN) on the NMT's
# global batch of 50 pairs, every dropout off and SGD with momentum as
# above: a beam-3 translate of this data rank's sentences to
# SCALE_TNMT_LEN (B4, B2), then steps on the whole-encoder-layer route
# (B5, B6, B8) and on the whole-decoder-layer route (B7)
SCALE_TNMT = dict(TNMT_TRAIN, dropout=0.0, nmt_optim="sgdm",
                  nmt_learning_rate=1e-2, nmt_max_grad_norm=5.0)
SCALE_TNMT_BEAM, SCALE_TNMT_LEN = 3, 20
# the counters of the kernels the transformer NMT's part launches, by the
# name of their record
SCALE_TNMT_COUNTERS = {
    "transformer_decode_stack": ("tdk", "stack_launches"),
    "row_topk": ("tk", "launches"),
    "mha_train_fwd": ("mhk", "fwd_launches"),
    "mha_train_bwd": ("mhk", "bwd_launches"),
    "enc_layer_train_fwd": ("ltk", "enc_fwd_launches"),
    "enc_layer_train_bwd": ("ltk", "enc_bwd_launches"),
    "dec_layer_train_fwd": ("ltk", "dec_fwd_launches"),
    "dec_layer_train_bwd": ("ltk", "dec_bwd_launches"),
    "ln_train_fwd": ("lnk", "fwd_launches"),
    "ln_train_bwd": ("lnk", "bwd_launches")}


def _scale_batch() -> tuple:
    """(the joint step's host batch with the SCST gts, the given (gen,
    greedy) samples [250, 16], the df corpus), seeded: each image's
    features repeated over its 5 caption rows, as the loader gives them."""
    rs = np.random.RandomState(31)
    fc, att = make_features(rs, SCALE_IMAGES)
    rows = SCALE_IMAGES * SCALE_CAPS
    v, t = CAP["vocab_size"], CAP["seq_length"]
    att_masks = np.ones((SCALE_IMAGES, N_SLOTS), np.float32)
    att_masks[1, 150:] = 0.0
    labels = np.zeros((rows, t + 2), np.int64)
    masks = np.zeros((rows, t + 2), np.float32)
    for i, length in enumerate(rs.randint(5, t + 1, rows)):
        labels[i, 1:1 + length] = rs.randint(1, v + 1, length)
        masks[i, :length + 2] = 1.0
    batch = {"fc_feats": np.repeat(fc, SCALE_CAPS, 0),
             "att_feats": np.repeat(att, SCALE_CAPS, 0),
             "att_masks": np.repeat(att_masks, SCALE_CAPS, 0),
             "labels": labels, "masks": masks}
    batch.update(make_nmt_batch(rs, SCALE_IMAGES))
    p = 1.0 / np.arange(1, v + 1)
    n = SCALE_DF_IMAGES * SCST_REFS
    words = rs.choice(v, size=(n, t), p=p / p.sum()) + 1
    lengths = rs.randint(8, t + 1, n)
    labels = np.where(np.arange(t)[None, :] < lengths[:, None], words, 0)
    start = np.arange(SCALE_DF_IMAGES) * SCST_REFS + 1
    gts = labels[:SCALE_IMAGES * SCST_REFS].reshape(SCALE_IMAGES, SCST_REFS,
                                                    t)
    batch["gts"] = np.repeat(gts, SCALE_CAPS, 0)
    batch["gts_masks"] = np.ones((rows, SCST_REFS), np.float32)
    gen, greedy = _given_seqs(rs, batch["gts"])
    return batch, (gen, greedy), (labels.astype(np.int32), start,
                                  start + SCST_REFS - 1)


def _scale_steps(device, mesh, run_dir: str, ref_path: str,
                 tnmt: bool = False):
    """The joint XE step twice (the second timed) and a joint SCST step on
    given samples, with TRAIN_KERNEL on, then a beam-3 decode of this data
    rank's images: on one device (`mesh` None) or as one rank of `mesh`,
    which trains on its data rank's block of the global batch. The launch
    counts of B1, B2 and B9 are set to 0 just before and read just after,
    and the shapes given to them recorded. Under a mesh the parameters are
    held against the one-device reference's saved at `ref_path`; without
    one they are saved there. With `tnmt`, then the transformer NMT's part
    (`_scale_tnmt`). Returns a picklable report."""
    import hashlib

    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.ops.cider import build_df_table
    from unpaired_image_captioning_tpu_torch.parallel.mesh import (
        axis, block_bounds, shard_batch)
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    batch, (gen, greedy), corpus = _scale_batch()
    mine = shard_batch(batch, mesh)     # this data rank's block
    df, n_img = compute_df(*corpus)
    rs = np.random.RandomState(12)
    cap_rows = 1 + rs.permutation(CAP["vocab_size"])[:JOINT_ROWS]
    src_rows = 4 + rs.permutation(NMT["src_vocab_size"] - 4)[:JOINT_ROWS]
    tr = Trainer(Config(**dict(SCALE_TRAIN, checkpoint_path=run_dir)),
                 device=device, mesh=mesh, joint_vocab=(cap_rows, src_rows),
                 df_table=build_df_table(df, n_img, device=device))
    _, d_rank, d_size = axis(mesh, "data")
    rows = SCALE_IMAGES * SCALE_CAPS
    lo, hi = block_bounds(rows, d_size, d_rank)
    given = {True: torch.from_numpy(greedy[lo:hi]).to(device),
             False: torch.from_numpy(gen[lo:hi]).to(device)}
    tr.i2t_model.sample = lambda feats, *, greedy=True, **_: (given[greedy],
                                                              None)
    old = _train_kernel_flag(True)
    shapes = {}
    att = aak.additive_attention

    def att_spy(p_att, att_h, alpha, mask, emb):
        shapes.setdefault("additive_attention", set()).add(
            (p_att.shape[0], p_att.shape[1], p_att.shape[2], emb.shape[2]))
        return att(p_att, att_h, alpha, mask, emb)

    aak.additive_attention = att_spy
    lk.launches = tk.launches = aak.launches = 0
    try:
        with _recording_shapes(shapes):
            m1 = tr.train(mine)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m2 = tr.train(mine)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            m3 = tr.train(mine, sc_flag=True)
            first = np.arange(0, rows, SCALE_CAPS)
            ilo, ihi = block_bounds(SCALE_IMAGES, d_size, d_rank)
            feats = Features(*(torch.from_numpy(batch[k][first][ilo:ihi]).to(
                device) for k in ("fc_feats", "att_feats")), None,
                torch.from_numpy(batch["att_masks"][first][ilo:ihi]).to(
                    device))
            with tr.whole_params(), torch.no_grad():
                seq = tr.i2t_model.sample_beam(feats, beam_size=3).seq
            torch.cuda.synchronize(device)
        counts = {"lstm_cell": lk.launches, "row_topk": tk.launches,
                  "additive_attention": aak.launches}
    finally:
        aak.additive_attention = att
        _train_kernel_flag(*old)
    shard_shapes = {f"{key}.{k}": (tuple(s.params[k].shape), s.dims[k])
                    for key, s in tr.shards.items() for k in s.dims}
    report = {"metrics": [m1, m2, m3], "wall": wall, "counts": counts,
              "shapes": {k: sorted(v, key=str) for k, v in shapes.items()},
              "shards": shard_shapes, "beam": tuple(seq.shape)}
    with tr.whole_params():
        whole = _scale_params(tr, mesh, ref_path, report)
        report["digest"] = {k: hashlib.sha256(v.cpu().numpy().tobytes())
                            .hexdigest() for k, v in whole.items()}
    if mesh is not None and run_dir:
        tr.save()
    if tnmt:
        del tr
        report["tnmt"] = _scale_tnmt(device, mesh, ref_path + ".tnmt")
    return report


def _scale_params(tr, mesh, ref_path: str, report: dict) -> dict:
    """The trainer's whole parameters ({model.leaf: tensor}, inside
    `whole_params`): saved at `ref_path` without a mesh, else held
    against the ones there within SCALE_TOL (the worst into `report`)."""
    import torch

    whole = {f"{key}.{k}": v.detach()
             for key, model in tr._models() if model is not None
             for k, v in model.state_dict().items()}
    if mesh is None:
        torch.save({k: v.cpu() for k, v in whole.items()}, ref_path)
        return whole
    ref = torch.load(ref_path, map_location=tr.device, weights_only=True)
    worst, name = 0.0, ""
    for k, v in whole.items():
        torch.testing.assert_close(v, ref[k], rtol=SCALE_TOL, atol=SCALE_TOL,
                                   msg=lambda m: f"{k}: {m}")
        e = (v - ref[k]).abs().max().item()
        if e > worst:
            worst, name = e, k
    report["param_err"] = (worst, name)
    report["whole_shapes"] = {k: tuple(v.shape) for k, v in whole.items()}
    return whole


class _recording_train_shapes:
    """While open, every call the training step makes to the forward
    wrappers of B5-B8 adds its shape to `shapes[name]`: mha_train (B, T,
    S, d, heads, mask kind, rate), ln_train (x's shape, eps), the
    encoder layer (B, S, d, d_ff, heads, rate, mask rows) and the decoder
    layer (B, T, S, d, d_ff, heads, rate, both masks' rows). The
    wrappers are wrapped in their modules, where the autograd functions
    call them."""

    def __init__(self, shapes: dict):
        from unpaired_image_captioning_tpu_torch.kernels import (
            layer_train as ltk)
        from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
        from unpaired_image_captioning_tpu_torch.kernels import (
            mha_train as mhk)

        def mha(a, kw):
            q, k, maskadd = a[0], a[1], a[3]
            kind = ("pad" if maskadd.shape[1] == 1 else
                    "causal" if q.shape[1] == k.shape[1] else "full")
            return (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    kw["n_heads"], kind, kw["rate"])

        def ln(a, kw):
            return (tuple(a[0].shape), a[3] if len(a) > 3
                    else kw.get("eps", 1e-6))

        def enc(a, kw):
            x, maskadd, w = a[0], a[1], a[3]
            return (x.shape[0], x.shape[1], x.shape[2], w["w1"].shape[1],
                    kw["n_heads"], kw["rate"], maskadd.shape[1])

        def dec(a, kw):
            x, mk, tmask, smask, w = a[0], a[1], a[3], a[4], a[6]
            return (x.shape[0], x.shape[1], mk.shape[1], x.shape[2],
                    w["w1"].shape[1], kw["n_heads"], kw["rate"],
                    tmask.shape[1], smask.shape[1])

        self._sites = [(mhk, "mha_train_fwd", "mha_train", mha),
                       (lnk, "ln_train_fwd", "ln_train", ln),
                       (ltk, "enc_layer_fwd", "enc_layer_train", enc),
                       (ltk, "dec_layer_fwd", "dec_layer_train", dec)]
        self._shapes = shapes

    __enter__ = _recording_shapes.__enter__
    __exit__ = _recording_shapes.__exit__


def _scale_tnmt(device, mesh, ref_path: str) -> dict:
    """The transformer NMT's part of a scale-out route (SCALE_TNMT): a
    beam-3 translate of this data rank's block of the global batch of 50
    pairs, then two steps on it on the whole-encoder-layer route (the
    second timed) and one on the whole-decoder-layer route.
    The counters of SCALE_TNMT_COUNTERS are set to 0 just before and read
    just after, the shapes given to B2, B4 and B5-B8 recorded; the
    parameters held against the one-device reference's as
    `_scale_params` does. Returns a picklable report."""
    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models import transformer as tm
    from unpaired_image_captioning_tpu_torch.parallel.mesh import shard_batch
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    mods = {"tdk": tdk, "tk": tk, "mhk": mhk, "ltk": ltk, "lnk": lnk}
    tr = Trainer(Config(**SCALE_TNMT), device=device, mesh=mesh)
    mine = shard_batch(make_nmt_batch(np.random.RandomState(37),
                                      SCALE_IMAGES), mesh)
    src, lengths = (torch.from_numpy(mine["nmt"][k]).to(device)
                    for k in ("src", "lengths"))
    shapes = {}
    rate, flags = tm.DROPOUT, _route_flags(True, False)
    tm.DROPOUT = 0.0
    for mod, attr in SCALE_TNMT_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    try:
        with _recording_shapes(shapes), _recording_train_shapes(shapes):
            # at the initial weights: three steps on these targets make
            # EOS every beam's first word
            with torch.no_grad():
                res = tr.nmt_model.translate_batch(
                    src, lengths, beam_size=SCALE_TNMT_BEAM,
                    max_len=SCALE_TNMT_LEN)
            m1 = tr.train(mine)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m2 = tr.train(mine)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            _route_flags(True, True)
            m3 = tr.train(mine)
            torch.cuda.synchronize(device)
        counts = {name: getattr(mods[mod], attr)
                  for name, (mod, attr) in SCALE_TNMT_COUNTERS.items()}
    finally:
        tm.DROPOUT = rate
        _route_flags(*flags)
    report = {"metrics": [m1, m2, m3], "wall": wall, "counts": counts,
              "shapes": {k: sorted(v, key=str) for k, v in shapes.items()},
              "translate": tuple(res.seq.shape)}
    _scale_params(tr, mesh, ref_path, report)
    return report


def _scale_rank(rank, world, mesh_shape, run_dir, ref_path, tnmt):
    """One rank of a scale-out route (started by `launch.run_ranks`)."""
    import torch

    from unpaired_image_captioning_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(world, mesh_shape)
    return _scale_steps(torch.device("cuda", torch.cuda.current_device()),
                        mesh, run_dir, ref_path, tnmt)


def _hold_train_shapes(dev, seen: dict) -> dict:
    """B5-B8 against their plain versions, forward and backward, at every
    shape `_recording_train_shapes` recorded (at its dropout rate and at
    TRAIN_RATE), as `phase_train_kernels` and `phase_layer_kernels` hold
    them; B4 at every shape `_recording_shapes` recorded, as
    `phase_tfd_kernels` does. Returns {kernel: the largest max|diff| /
    max(1, max|plain|)}; raises above the tolerance."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto
    from unpaired_image_captioning_tpu_torch.ops import ln_train as lno
    from unpaired_image_captioning_tpu_torch.ops import mha_train as mho
    from unpaired_image_captioning_tpu_torch.ops import (
        transformer_decode as td)

    gen = torch.Generator(device=dev).manual_seed(41)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    errs = {}

    def note(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    for b, t, s, d, heads, kind, rate in seen.get("mha_train", ()):
        if kind == "full":
            raise AssertionError(f"mha_train at {(b, t, s, d)}: a [B, T, S] "
                                 "mask over T != S, which no check builds")
        q, k, v, g, maskadd = _mha_inputs(dev, gen, b, t, s, kind, d)
        for r in sorted({rate, TRAIN_RATE}):
            kw = dict(n_heads=heads, rate=r)
            out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
            grads = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                                      **kw)
            ref_stats = mho.softmax_stats(q, k, maskadd, n_heads=heads)
            label = f"mha_train B={b} T={t} S={s} d={d} H={heads} rate={r}"
            note("mha_train_fwd", _check_close(
                label, [out, stats[0], stats[1]],
                [mho.mha_train_plain(q, k, v, maskadd, seed, **kw),
                 ref_stats[0], ref_stats[1]]))
            note("mha_train_bwd", _check_close(
                label + " bwd", grads,
                mho.mha_train_plain_bwd(q, k, v, maskadd, seed, g, **kw)))
    for shape, eps in seen.get("ln_train", ()):
        x = torch.randn(shape, generator=gen, device=dev) * 3 + 1
        g = torch.randn(shape, generator=gen, device=dev)
        scale = 1 + 0.1 * torch.randn((shape[-1],), generator=gen,
                                      device=dev)
        offset = 0.1 * torch.randn((shape[-1],), generator=gen, device=dev)
        label = f"ln_train {list(shape)}"
        note("ln_train_fwd", _check_close(
            label, [lnk.ln_train_fwd(x, scale, offset, eps)],
            [lno.ln_train_plain(x, scale, offset, eps)]))
        note("ln_train_bwd", _check_close(
            label + " bwd", lnk.ln_train_bwd(x, scale, g, eps),
            lno.ln_train_plain_bwd(x, scale, g, eps)))
    for b, s, d, f, heads, rate, rows in seen.get("enc_layer_train", ()):
        if rows != 1:
            raise AssertionError(f"enc_layer_train at {(b, s, d)}: a mask "
                                 f"of {rows} rows, which no check builds")
        x, g, _, maskadd, lseed, w, _ = _enc_layer_inputs(dev, gen, b, s, d,
                                                          f)
        ws = [w[k] for k in lto.ENC_WEIGHTS]
        for r in sorted({rate, TRAIN_RATE}):
            kw = dict(n_heads=heads, rate=r)
            label = (f"enc_layer_train B={b} S={s} d={d} d_ff={f} H={heads} "
                     f"rate={r}")
            out, saved = ltk.enc_layer_fwd(x, maskadd, lseed, w, **kw)
            grads = ltk.enc_layer_bwd(x, maskadd, lseed, w, saved, g, **kw)
            ref, x2 = lto.enc_fwd_plain(x, maskadd, lseed, *ws, **kw)
            refs = lto.enc_bwd_plain(x, maskadd, lseed, x2, g, *ws, **kw,
                                     relu_active=saved[-1] > 0)
            note("enc_layer_train_fwd", _check_each(
                label, ("out", "x2"), (out, saved[0]), (ref, x2)))
            note("enc_layer_train_bwd", _check_each(
                label + " bwd", ("dx",) + lto.ENC_WEIGHTS, grads, refs))
    for b, t, s, d, f, heads, rate, trows, srows in seen.get(
            "dec_layer_train", ()):
        if (trows, srows) != (t, 1):
            raise AssertionError(f"dec_layer_train at {(b, t, s, d)}: masks "
                                 f"of {trows} and {srows} rows, which no "
                                 "check builds")
        x, g = (torch.randn((b, t, d), generator=gen, device=dev)
                for _ in range(2))
        mk, mv = (torch.randn((b, s, d), generator=gen, device=dev)
                  for _ in range(2))
        pos_s, pos_t = torch.arange(s, device=dev), torch.arange(t, device=dev)
        src_len = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        src_len[0] = s
        keep = (pos_s[None, :] < src_len[:, None])[:, None, :]
        tgt_len = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
        pad_ok = (pos_t[None, :] < tgt_len[:, None]) | (pos_t[None, :] == 0)
        tkeep = pad_ok[:, None, :] & (pos_t[None, :] <= pos_t[:, None])[None]
        tmask = torch.where(tkeep, 0.0, -1e9).contiguous()
        smask = torch.where(keep, 0.0, -1e9).contiguous()
        seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                             device=dev)
        w = _layer_weights(gen, dev, lto.DEC_WEIGHTS, d, f)
        ws = [w[k] for k in lto.DEC_WEIGHTS]
        args = (x, mk, mv, tmask, smask, seeds)
        for r in sorted({rate, TRAIN_RATE}):
            kw = dict(n_heads=heads, rate=r)
            label = (f"dec_layer_train B={b} T={t} S={s} d={d} d_ff={f} "
                     f"H={heads} rate={r}")
            out, saved = ltk.dec_layer_fwd(*args, w, **kw)
            grads = ltk.dec_layer_bwd(*args, w, saved, g, **kw)
            ref, x2, x3 = lto.dec_fwd_plain(*args, *ws, **kw)
            refs = lto.dec_bwd_plain(*args, x2, x3, g, *ws, **kw,
                                     relu_active=saved[-1] > 0)
            note("dec_layer_train_fwd", _check_each(
                label, ("out", "x2", "x3"), (out, saved[0], saved[1]),
                (ref, x2, x3)))
            note("dec_layer_train_bwd", _check_each(
                label + " bwd", ("dx", "dmk", "dmv") + lto.DEC_WEIGHTS,
                grads, refs))
    for key in seen.get("transformer_decode_stack", ()):
        b, kb, n_l, n_t, slots, d, dff, heads, lazy = key
        if lazy is None:
            raise AssertionError(f"transformer_decode_stack at {key}: the "
                                 "lazy ancestry without want_attn, which "
                                 "no check builds")
        a = _tfd_inputs(dev, gen, b, kb, n_l, n_t, slots, d, dff, lazy)
        outs = [fn(a["x"], a["t"], a["ck"], a["cv"], a["mask"],
                   a["kc"].clone(), a["vc"].clone(), a["w"], a["anc"],
                   n_heads=heads, want_attn=lazy)
                for fn in (tdk.decoder_stack_step,
                           td.decoder_stack_step_plain)]
        e = _rel_err(*outs)
        if not e <= TFD_TOL:
            raise AssertionError(f"transformer_decode_stack at {key}: max|"
                                 f"diff| / max(1, max|plain|) = {e} > "
                                 f"{TFD_TOL}")
        note("transformer_decode_stack", e)
    torch.cuda.synchronize()
    return errs


def phase_scale_out(dev, root: str) -> tuple:
    """Scale-out (`parallel/`, the trainer's `mesh=`) at the joint recipe's
    width and global batch (SCALE_TRAIN: denseatt + BiLSTM NMT with
    Weight_Trans, 50 images x 5 captions): the card's one-device steps
    (`_scale_steps`) are the reference; then, on routes chosen from the
    card count before any runs, the same steps on ranks that share the
    card over gloo ("2", and "1x2" with the tensor-parallel placements),
    on one NCCL rank, and across cards over NCCL where two are visible.
    The "2" route and the reference also take the transformer NMT's steps
    and translate (`_scale_tnmt`). Each route's losses and parameters must
    equal the reference's within SCALE_TOL, each rank must launch B1, B2
    and B9 (and on the "2" route B4-B8), each "1x2" rank must hold half of
    every model-sharded leaf, and the "2" route's checkpoint must load
    into a one-device Trainer bit for bit. Every shape the ranks give B1,
    B2 and B4-B9 is then held against its plain version. Last, the
    loader's read of one global batch against a rank's block of it
    (`_scale_reads`). Returns (rank 0's launches on the "2" route, the
    cells' and the top-k records)."""
    import os

    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.ops import attention as ao
    from unpaired_image_captioning_tpu_torch.parallel import launch
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    routes = [("gloo 2 ranks on one card", 2, "data", "gloo", False,
               ["cuda:0"] * 2),
              ("gloo 1x2 ranks on one card (tensor parallel)", 2, "1x2",
               "gloo", True, ["cuda:0"] * 2),
              ("nccl 1 rank", 1, "data", "nccl", False, ["cuda:0"])]
    if n_cards >= 2:
        routes.append(("nccl 2 ranks on two cards", 2, "data", "nccl", False,
                       ["cuda:0", "cuda:1"]))
    log(f"scale-out: {n_cards} card(s) visible, so the routes are: "
        + "; ".join(r[0] for r in routes)
        + ("" if n_cards >= 2 else " (no NCCL route across cards: one card)")
        + ". gloo carries the ranks' CUDA tensors through host copies "
        "(parallel/mesh.py stages every collective), so the 1x2 route runs "
        "on the card.")
    ref_path = os.path.join(root, "scale_ref.pt")
    ref = _scale_steps(dev, None, "", ref_path, tnmt=True)
    t_ref = time.perf_counter()
    reports = {}
    for label, world, shape, backend, tp, devices in routes:
        # the first route writes the checkpoint that is loaded below
        run_dir = os.path.join(root, "scale_ckpt") if not reports else ""
        t1 = time.perf_counter()
        # the transformer NMT's steps ride on the first route
        tnmt = not reports
        ranks = launch.run_ranks(_scale_rank, world,
                                 (shape, run_dir, ref_path, tnmt),
                                 backend=backend, timeout=300.0,
                                 devices=devices)
        for r, rep in enumerate(ranks):
            parts = [("", rep, ref, SCALE_KERNELS)]
            if tnmt:
                parts.append(("transformer NMT ", rep["tnmt"], ref["tnmt"],
                              tuple(SCALE_TNMT_COUNTERS)))
            for what, got_rep, ref_rep, names in parts:
                for i, (got, want) in enumerate(zip(got_rep["metrics"],
                                                    ref_rep["metrics"])):
                    for k, w in want.items():
                        if not abs(got[k] - w) <= SCALE_TOL * max(1.0,
                                                                  abs(w)):
                            raise AssertionError(
                                f"scale-out {label}: rank {r} {what}step "
                                f"{i + 1} {k} {got[k]} vs one device's {w}")
                if not all(got_rep["counts"][k] for k in names):
                    raise AssertionError(
                        f"scale-out {label}: rank {r} did not launch every "
                        f"{what}kernel: {got_rep['counts']}")
            if tp:
                if not rep["shards"]:
                    raise AssertionError(f"scale-out {label}: rank {r} "
                                         "holds no model-sharded leaf")
                for leaf, (shp, dim) in rep["shards"].items():
                    whole = rep["whole_shapes"][leaf]
                    half = tuple(w // 2 if i == dim else w
                                 for i, w in enumerate(whole))
                    if shp != half:
                        raise AssertionError(
                            f"scale-out {label}: rank {r} holds {leaf} "
                            f"{shp}, not half of {whole}")
        reports[label] = (ranks, time.perf_counter() - t1, run_dir)
    t_routes = time.perf_counter()

    # the checkpoint of the "2" route into a one-device Trainer
    ranks, _, run_dir = reports[routes[0][0]]
    tr = Trainer(Config(**dict(SCALE_TRAIN, checkpoint_path=run_dir)),
                 device=dev)
    infos = tr.load()
    import hashlib

    for key, model in tr._models():
        for k, v in model.state_dict().items():
            h = hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            if h != ranks[0]["digest"][f"{key}.{k}"]:
                raise AssertionError(f"scale-out: the 2-rank checkpoint's "
                                     f"{key}.{k} differs from the ranks'")
    if infos["iter"] != 3 or len(infos["data_generators"]) != 2:
        raise AssertionError(f"scale-out: checkpoint infos {infos['iter']}")
    del tr

    # every shape the ranks gave B1, B2, B4-B9, against the plain versions
    seen = {}
    for rep in [ref] + [x for v in reports.values() for x in v[0]]:
        for part in (rep, rep.get("tnmt", {"shapes": {}})):
            for k, v in part["shapes"].items():
                seen.setdefault(k, set()).update(
                    tuple(tuple(e) if isinstance(e, list) else e for e in s)
                    for s in v)
    cell_rows = {}
    # keys of bf16 mixtures (the card's eval rounds the features) are held
    # apart, at their types
    _unheld(dev, "lstm_cell", seen.get("lstm_cell", set()), set())
    for key in seen.get("lstm_cell", ()):
        if len(key) == 4:
            b, d, h, maxout = key
            cell_rows.setdefault((d, h, maxout), set()).add(b)
    cells, topk = _family_cells(
        dev, [(f"scale-out G={5 if m else 4} {d}->{h}", d, h, m,
               tuple(sorted(rows)))
              for (d, h, m), rows in sorted(cell_rows.items())],
        [(f"scale-out beam rows {r}", r, v, k)
         for r, v, k in sorted(seen.get("row_topk", ()))],
        timed=set(), topk_timed=set(), seed=23)
    gen = torch.Generator(device=dev).manual_seed(29)
    worst = 0.0
    for widths in sorted(seen.get("additive_attention", ())):
        args = _att_inputs(dev, gen, None, widths)
        worst = max(worst, _att_check(f"additive_attention {widths}",
                                      [aak.additive_attention(*args)],
                                      [ao.reference_attention(*args)]))
    log(f"scale-out additive_attention at {sorted(seen['additive_attention'])}"
        f": max|diff| / max(1, max|plain|) {worst:.3g} (tol {ATT_TOL})")
    held = _hold_train_shapes(dev, seen)
    for name in ("mha_train", "ln_train", "enc_layer_train",
                 "dec_layer_train", "transformer_decode_stack"):
        log(f"scale-out {name} shapes: {sorted(seen.get(name, ()), key=str)}")
    log("scale-out B4-B8 at those shapes: max|diff| / max(1, max|plain|) "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(held.items()))
        + f" (tol {TRAIN_TOL}; the decoder step {TFD_TOL})")
    if set(held) != {k for k in SCALE_TNMT_COUNTERS if k != "row_topk"}:
        raise AssertionError(f"scale-out: no shape held for "
                             f"{set(SCALE_TNMT_COUNTERS) - set(held)}")
    reads = _scale_reads(os.path.join(root, "reads"))
    end = time.perf_counter()
    ref_wall = ref["wall"]
    lines = [f"one device: joint XE step {ref_wall * 1e3:.1f} ms, losses "
             + ", ".join(f"{k} {v:.6f}" for k, v in ref["metrics"][1].items()
                         if k.endswith("loss"))]
    for label, (ranks, secs, _) in reports.items():
        errs = [r.get("param_err", (0.0, ""))[0] for r in ranks]
        lines.append(
            f"{label}: joint XE step " + " / ".join(
                f"{r['wall'] * 1e3:.1f}" for r in ranks)
            + f" ms (rank walls; {ranks[0]['wall'] / ref_wall:.2f}x one "
            f"device), parameters max|diff| {max(errs):.3g}, losses within "
            f"{SCALE_TOL}, launches " + " / ".join(
                str(r["counts"]) for r in ranks)
            + (f", {len(ranks[0]['shards'])} leaves in halves"
               if ranks[0]["shards"] else "") + f"; route {secs:.1f} s")
    ranks = reports[routes[0][0]][0]
    tn_ref = ref["tnmt"]
    lines.append(
        f"transformer NMT (d 512, 6 + 6 layers, 50 pairs): one device's "
        f"step {tn_ref['wall'] * 1e3:.1f} ms, losses " + ", ".join(
            f"{k} {v:.6f}" for k, v in tn_ref["metrics"][1].items()
            if k.endswith("loss"))
        + f"; {routes[0][0]}: step " + " / ".join(
            f"{r['tnmt']['wall'] * 1e3:.1f}" for r in ranks)
        + f" ms (rank walls; {ranks[0]['tnmt']['wall'] / tn_ref['wall']:.2f}x"
        " one device), parameters max|diff| "
        + f"{max(r['tnmt']['param_err'][0] for r in ranks):.3g}, losses "
        f"within {SCALE_TOL}, beam-{SCALE_TNMT_BEAM} translate "
        + " / ".join(str(r["tnmt"]["translate"]) for r in ranks)
        + ", launches " + " / ".join(str(r["tnmt"]["counts"]) for r in ranks))
    lines.append(
        f"the loader's read of one training batch ({SCALE_IMAGES} images x "
        f"{SCALE_CAPS} captions from .npy files, warm page cache, host "
        "clock, mean of 3 after one): " + ", ".join(
            f"{label} {ms:.1f} ms ({n} rows)" for label, ms, n in reads))
    log("scale-out on " + (CARD[0] if CARD else "the card") + ": "
        + "; ".join(lines) + f"; the 2-rank checkpoint loads into a "
        f"one-device Trainer bit for bit; phase seconds: reference "
        f"{t_ref - t0:.1f}, routes {t_routes - t_ref:.1f}, checks "
        f"{end - t_routes:.1f}; all {end - t0:.1f}")
    counts = dict(ranks[0]["counts"])
    for k, n in ranks[0]["tnmt"]["counts"].items():
        counts[k] = counts.get(k, 0) + n
    return counts, cells, topk


def _scale_reads(root: str) -> list:
    """The loader's host time for one training batch of the recipe's
    shape (SCALE_IMAGES images x SCALE_CAPS captions, CAP's fc and 196 x
    2,048 att features as one .npy file each) read whole and as each
    rank's block of 2 data ranks (`data_rank`). Returns [(label, mean ms,
    rows)]."""
    import os

    from unpaired_image_captioning_tpu_torch.data import synthetic
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)

    os.makedirs(root, exist_ok=True)
    jpath, label, mem = synthetic.make_caption_artifacts(
        root, n_images=SCALE_IMAGES + 2, vocab_size=CAP["vocab_size"],
        seq_length=CAP["seq_length"], caps_per_img=SCALE_CAPS,
        fc_dim=CAP["fc_feat_size"], att_dim=CAP["att_feat_size"],
        att_len=N_SLOTS, seed=0, n_val=1, n_test=1)
    fc_dir, att_dir = synthetic.write_feature_dirs(root, mem)
    del mem
    out = []
    for name, rank, parts in (("1 rank", 0, 1), ("rank 0 of 2", 0, 2),
                              ("rank 1 of 2", 1, 2)):
        loader = CaptionDataLoader(
            input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
            input_att_dir=att_dir, batch_size=SCALE_IMAGES,
            seq_per_img=SCALE_CAPS, att_feat_size=CAP["att_feat_size"],
            data_rank=rank, num_data_ranks=parts)
        loader.get_batch("train")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch = loader.get_batch("train")
            walls.append(time.perf_counter() - t0)
        out.append((name, statistics.mean(walls) * 1e3,
                    len(batch["att_feats"])))
    return out


# ---------------------------------------------------------------------------
# the compute dtype (A15): the bf16 entries of B1, B9a-c and B10, then the
# bf16 path on the card
# ---------------------------------------------------------------------------

BF16_TOL = 1e-2      # rtol = atol, JAX's bf16 tolerance (tests/test_ln_train.py:61-71)
BF16_ITERS = 5       # timed calls of each bf16 entry and its plain version
BF16_FLOPS = 989e12  # an H100 SXM's dense bf16 tensor-core rate
# B1's mixtures (x, (w, b), (h, c)) on the bf16 routes: bf16 features with
# f32 weights (serving, eval: lstm0's x is f32, lstm1/2's bf16), the cast
# training route, and the decode step's cell under a bf16 copy of the
# weights (its x, [h0d | att1], stays f32)
BF16_CELL_MIXES = (("f32", "f32", "bf16"), ("bf16", "f32", "bf16"),
                   ("bf16", "bf16", "bf16"), ("f32", "bf16", "bf16"))
# (label, B, D, H, maxout)
BF16_CELL_SHAPES = [
    ("denseatt lstm0/1/2 and B9c, batch 50", 50, 1024, 512, True),
    ("denseatt lstm0/1/2, recipe eval beam 3 x 50", 150, 1024, 512, True),
    ("nmt encoder, per direction", 50, 512, 256, False),
    ("nmt teacher-forced decoder, batch 50", 50, 1024, 512, False)]
# B1's tensor-core instance (all bf16) also at ragged shapes: (B, D, H,
# maxout) with D and H not multiples of 8 (element copies), and multiples
# of 8 but not of 16 with B not a multiple of 16
BF16_CELL_RAGGED = [(37, 100, 76, True), (5, 13, 29, False),
                    (70, 24, 40, True)]
# B9a / B9b (p_att, q, alpha, mask, emb): decoding bf16 features with f32
# weights (decode_ctx widens p_att), the cast training forward, the cast
# route's SCST decodes, and the teacher-forced forward of bf16 features
# with f32 weights
BF16_ATT_MIXES = (("f32", "bf16", "f32", "f32", "bf16"),
                  ("bf16", "bf16", "bf16", "f32", "bf16"),
                  ("f32", "bf16", "bf16", "f32", "bf16"),
                  ("bf16", "bf16", "f32", "f32", "bf16"))
BF16_ATT_BEAMS = (3, 5)
# B9c (p_att, emb, mask, q1, h0d, carry, w1 / b1, the products, alphas):
# decoding bf16 features with f32 weights, and the cast route's decodes
BF16_STEP_MIXES = (("f32", "bf16", "f32", "bf16", "bf16", "bf16", "f32",
                    "f32", "f32"),
                   ("f32", "bf16", "f32", "bf16", "bf16", "bf16", "bf16",
                    "bf16", "bf16"))
# B10 (the carry, w_h2h) with an f32 x_contrib, G = 5 and G = 4
BF16_CHAIN_MIXES = ((5, "bf16", "bf16"), (5, "bf16", "f32"),
                    (5, "f32", "bf16"), (4, "bf16", "bf16"))


def _dt(name: str):
    import torch

    return torch.bfloat16 if name == "bf16" else torch.float32


def _mix_name(dtypes) -> str:
    return "/".join("bf16" if "bfloat16" in str(t) or t == "bf16" else "f32"
                    for t in dtypes)


def _bf16_close(name: str, got, want) -> float:
    """Each output: |kernel - plain| <= BF16_TOL + BF16_TOL * |plain|,
    elementwise in f32, types equal; returns the largest |diff| / (1 +
    |plain|)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: kernel {a.dtype} {tuple(a.shape)}"
                                 f" against plain {b.dtype} {tuple(b.shape)}")
        a, b = a.float(), b.float()
        if not bool(((a - b).abs() <= BF16_TOL + BF16_TOL * b.abs()).all()):
            raise AssertionError(f"{name}: max|diff| {(a - b).abs().max()}"
                                 f" past rtol = atol = {BF16_TOL}")
        worst = max(worst, ((a - b).abs() / (1 + b.abs())).max().item())
    return worst


def bound_mixed(nbytes_: float, f32_flops: float, bf16_flops: float,
                transcendentals: float = 0.0):
    """`bound` where the products of two bf16 operands may run at the bf16
    tensor-core rate and the rest at the f32 FMA rate."""
    ops_ms = (f32_flops / F32_FLOPS + bf16_flops / BF16_FLOPS) * 1e3
    terms = [(nbytes_ / HBM_BYTES_S * 1e3, "bytes"), (ops_ms, "operations")]
    if transcendentals:
        terms.append((transcendentals / SFU_RATE[0] * 1e3, "transcendentals"))
    return max(terms, key=lambda t: t[0])


def _bf16_record(name, src, line, rows):
    main = rows[0]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": "unpaired_image_captioning_tpu/ops/" + line,
            "max_abs_err": max(r["err"] for r in rows),
            "err_is": "max |diff| / (1 + |plain|), held at rtol = atol = "
                      f"{BF16_TOL}",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["label"],
            "timing": main["timing"], "shapes": rows, "launches": 0}


def phase_bf16_kernels(dev, kernels: dict) -> tuple:
    """The bf16 entries (A15) against their plain versions on the card, in
    every dtype mixture the routes give them, at the path shapes, each
    timed beside the f32 entry at the same shape. Returns (the JSON
    records, the held keys {kernel: {(shape..., types)}})."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.ops import attention as ao
    from unpaired_image_captioning_tpu_torch.ops import lstm_block as lo

    gen = torch.Generator(device=dev).manual_seed(21)
    rec, held = {}, {"lstm_cell": set(), "additive_attention": set(),
                     "additive_attention_beams": set(), "att_lstm_att": set(),
                     "lstm_chain": set()}
    f32_cells = {r["shape"]: r["ms"] for r in kernels["lstm_cell"]["shapes"]}

    def row(label, kfn, pfn, names, by, f32_flops, bf16_flops, err,
            trans=0.0, lib=None, f32_ms=None):
        k_ms, p_ms, k_wall, p_wall, how = time_pair(kfn, pfn, names,
                                                    iters=BF16_ITERS)
        b_ms, term = bound_mixed(by, f32_flops, bf16_flops, trans)
        lib_ms = (library_ms(lib, iters=BF16_ITERS)[0] if lib is not None
                  else None)
        fmt = (lambda v: "none" if v is None else f"{v:.4f} ms")
        log(f"kernel {label}: |diff| / (1 + |plain|) {err:.3g} (held at rtol "
            f"= atol = {BF16_TOL}); {how}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms; per call {k_wall:.4f} / {p_wall:.4f} ms; bound "
            f"{b_ms:.4f} ms ({term}; bf16 elements 2 bytes); f32 entry "
            f"{fmt(f32_ms)}; library {fmt(lib_ms)}")
        return dict(label=label, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by="bytes" if term == "bytes" else "operations",
                    bound_term=term, library_ms=lib_ms, wall_ms=k_wall,
                    plain_wall_ms=p_wall, timing=how, err=err,
                    f32_entry_ms=f32_ms)

    # B1
    rows = []
    for label, b, d, h, maxout in BF16_CELL_SHAPES:
        g = 5 if maxout else 4
        scale = 1.0 / h ** 0.5
        w = (torch.rand((d + h, g * h), generator=gen, device=dev) * 2 - 1) * scale
        bias = (torch.rand((g * h,), generator=gen, device=dev) * 2 - 1) * scale
        x = torch.randn((b, d), generator=gen, device=dev)
        h0 = torch.randn((b, h), generator=gen, device=dev)
        c0 = torch.randn((b, h), generator=gen, device=dev)
        for mix in BF16_CELL_MIXES:
            tx, tw, th = (_dt(m) for m in mix)
            args = (w.to(tw), bias.to(tw), x.to(tx), h0.to(th), c0.to(th))
            before, tc0 = lk.bf16_launches, lk.tc_launches
            all_bf = mix == ("bf16", "bf16", "bf16")
            got = lk.lstm_cell(*args, maxout=maxout)
            if lk.bf16_launches != before + 1:
                raise AssertionError(f"lstm_cell {mix}: no bf16 launch")
            if lk.tc_launches != tc0 + all_bf:
                raise AssertionError(f"lstm_cell {mix}: the tensor-core "
                                     f"instance ran {lk.tc_launches - tc0} "
                                     f"times, expected {int(all_bf)}")
            if all_bf:
                again = lk.lstm_cell(*args, maxout=maxout)
                if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
                    raise AssertionError(f"lstm_cell {mix} [{b}, {d}->{h}]: "
                                         "a rerun differs")
                log(f"lstm_cell tensor-core plan G={g} [{b}, {d}->{h}]: "
                    f"{lk.plan_tc(b, d, h)} (the FMA core's "
                    f"{lk.plan(b, d, h)}); a rerun bit for bit")
            want = lk.lstm_cell_plain(*args, maxout=maxout)
            torch.cuda.synchronize()
            shape = f"G={g} [{b}, {d}->{h}] x/w/h {'/'.join(mix)}"
            err = _bf16_close(f"lstm_cell {shape}", got, want)
            held["lstm_cell"].add((b, d, h, maxout, mix))
            prods = [(2.0 * b * d * g * h, mix[0] == mix[1] == "bf16"),
                     (2.0 * b * h * g * h, mix[1] == mix[2] == "bf16")]
            lib = None
            if g == 4 and mix == ("bf16", "bf16", "bf16"):
                cols = torch.cat([torch.arange(j * h, (j + 1) * h, device=dev)
                                  for j in (0, 1, 3, 2)])
                wa, ba = args[0], args[1]
                w_ih = wa[:d, cols].t().contiguous()
                w_hh = wa[d:, cols].t().contiguous()
                b_ih, b_hh = ba[cols].contiguous(), torch.zeros_like(ba)

                def lib(a=args, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh):
                    return torch.lstm_cell(a[2], (a[3], a[4]), w_ih, w_hh,
                                           b_ih, b_hh)
            f32_ms = next((ms for s, ms in f32_cells.items()
                           if s == f"G={g} [{b}, {d}->{h}]"), None)
            rows.append(row(
                f"lstm_cell {shape} ({label})",
                lambda a=args: lk.lstm_cell(*a, maxout=maxout),
                lambda a=args: lk.lstm_cell_plain(*a, maxout=maxout),
                LSTM_KERNELS, nbytes(*args, *got),
                sum(f for f, bf in prods if not bf),
                sum(f for f, bf in prods if bf), err, lib=lib,
                f32_ms=f32_ms))
    # the tensor-core instance at ragged shapes (held, not timed)
    for b, d, h, maxout in BF16_CELL_RAGGED:
        g = 5 if maxout else 4
        args = tuple(t.to(torch.bfloat16) for t in (
            (torch.rand((d + h, g * h), generator=gen, device=dev) - 0.5) / 8,
            (torch.rand((g * h,), generator=gen, device=dev) - 0.5) / 8,
            torch.randn((b, d), generator=gen, device=dev),
            torch.randn((b, h), generator=gen, device=dev),
            torch.randn((b, h), generator=gen, device=dev)))
        tc0 = lk.tc_launches
        got = lk.lstm_cell(*args, maxout=maxout)
        again = lk.lstm_cell(*args, maxout=maxout)
        want = lk.lstm_cell_plain(*args, maxout=maxout)
        torch.cuda.synchronize()
        shape = f"G={g} [{b}, {d}->{h}] x/w/h bf16/bf16/bf16 (ragged)"
        err = _bf16_close(f"lstm_cell {shape}", got, want)
        if lk.tc_launches != tc0 + 2 or not all(
                torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            raise AssertionError(f"lstm_cell {shape}: not twice on the "
                                 "tensor cores with the same bits")
        log(f"kernel lstm_cell {shape}: |diff| / (1 + |plain|) {err:.3g} "
            f"(held at rtol = atol = {BF16_TOL}), tensor-core plan "
            f"{lk.plan_tc(b, d, h)}, a rerun bit for bit")
    rec["lstm_cell_bf16"] = _bf16_record(
        "lstm_cell_bf16",
        "unpaired_image_captioning_tpu_torch/csrc/lstm_cell.cu",
        "rnn.py:72", rows)

    # B9a and B9b
    b, n, a = BENCH_BATCH, N_SLOTS, CAP["att_hid_size"]
    d = h = CAP["rnn_size"]
    f32_att = kernels["additive_attention"]["ms"]
    f32_beams = {r["label"].split(" ")[1]: r["ms"]
                 for r in kernels["additive_attention_beams"]["shapes"]}
    for name, ks in (("additive_attention", (None,)),
                     ("additive_attention_beams", BF16_ATT_BEAMS)):
        rows = []
        for k in ks:
            base = _att_inputs(dev, gen, k)
            for mix in BF16_ATT_MIXES:
                args = tuple(t.to(_dt(m)) for t, m in zip(base, mix))
                fn = (aak.additive_attention if k is None
                      else aak.additive_attention_beams)
                pfn = (ao.reference_attention if k is None
                       else ao.reference_attention_beams)
                out = fn(*args)
                want = pfn(*args)
                torch.cuda.synchronize()
                kk = 1 if k is None else k
                shape = (f"B={b}" + ("" if k is None else f" K={k}")
                         + f" N={n} A={a} D={d} p_att/q/alpha/mask/emb "
                         + "/".join(mix))
                err = _bf16_close(f"{name} {shape}", [out], [want])
                held[name].add((b, kk, n, a, d, mix))
                rows.append(row(
                    f"{name} {shape}", lambda a_=args, f=fn: f(*a_),
                    lambda a_=args, f=pfn: f(*a_),
                    "additive_attention_kernel", nbytes(*args, out),
                    2.0 * b * kk * n * (a + d), 0.0, err,
                    trans=b * kk * n * (a + 1.0),
                    f32_ms=(f32_att if k is None
                            else f32_beams.get(f"K={k}"))))
        rec[f"{name}_bf16"] = _bf16_record(
            f"{name}_bf16",
            "unpaired_image_captioning_tpu_torch/csrc/additive_attention.cu",
            "attention.py:" + ("46" if k is None else "66"), rows)

    # B9c
    rows = []
    base = _step_args(dev, gen)
    groups = ((0,), (1,), (2,), (3,), (4,), (5, 6), (7, 8), (9, 10, 11, 12),
              (13, 14))
    for mix in BF16_STEP_MIXES:
        step = list(base)
        for idx, m in zip(groups, mix):
            for i in idx:
                step[i] = step[i].to(_dt(m))
        with torch.no_grad():
            outs = aak.fused_att_lstm_att(*step)
            want = ao.att_lstm_att_plain(*step)
            torch.cuda.synchronize()
            shape = (f"B={b} N={n} A={a} D={d} H={h} "
                     + "/".join(mix))
            err = _bf16_close(f"att_lstm_att {shape}", outs, want)
            held["att_lstm_att"].add((b, n, a, d, h, mix))
            cell_bf = mix[5] == mix[6] == "bf16"
            rows.append(row(
                f"att_lstm_att {shape}",
                lambda s=step: aak.fused_att_lstm_att(*s),
                lambda s=step: ao.att_lstm_att_plain(*s),
                STEP_KERNELS + ("rows_gemm_bf16w", "round_pair_kernel"),
                nbytes(*step, *outs),
                2.0 * b * (2 * n * (a + d) + (2 * h + d) * 5 * h * (not cell_bf)
                           + d * h + h * a),
                2.0 * b * h * 5 * h * cell_bf, err,
                trans=b * (2 * n * (a + 1.0) + 5 * h),
                f32_ms=kernels["att_lstm_att"]["ms"]))
    rec["att_lstm_att_bf16"] = _bf16_record(
        "att_lstm_att_bf16",
        "unpaired_image_captioning_tpu_torch/csrc/additive_attention.cu",
        "attention.py:227", rows)

    # B10
    bt, t, d, h = CHAIN_SHAPE
    rows = {"fwd": [], "bwd": []}
    f32_chain = {key: {r["shape"]: r["ms"]
                       for r in kernels[f"lstm_chain_{key}"]["shapes"]}
                 for key in ("fwd", "bwd")}
    for g, tc, tw in BF16_CHAIN_MIXES:
        w, bias, x, h0, c0, ch, cc = _chain_inputs(dev, gen, g)
        xc = (x.reshape(t * bt, d) @ w[:d] + bias).reshape(t, bt, g * h)
        w_hh = w[d:].contiguous().to(_dt(tw))
        h0c, c0c = h0.to(_dt(tc)), c0.to(_dt(tc))
        chc, ccc = ch.to(_dt(tc)), cc.to(_dt(tc))
        maxout = g == 5
        hs, cs, gates = lb.chain_fwd(xc, h0c, c0c, w_hh, maxout=maxout)
        dg, dh0, dc0 = lb.chain_bwd(gates, cs, c0c, chc, ccc, w_hh,
                                    maxout=maxout)
        phs, pcs, pgates = lo.chain_fwd_plain(xc, h0c, c0c, w_hh,
                                              maxout=maxout)
        pdg, pdh0, pdc0 = lo.chain_bwd_plain(gates, cs, c0c, chc, ccc, w_hh,
                                             maxout=maxout)
        torch.cuda.synchronize()
        mix = (tc, tw)
        shape = f"G={g} [T {t}, B {bt}, H {h}] carry/w_h2h {tc}/{tw}"
        e_f = _bf16_close(f"lstm_chain forward {shape}", [hs, cs, gates],
                          [phs, pcs, pgates])
        e_b = _bf16_close(f"lstm_chain backward {shape}", [dg, dh0, dc0],
                          [pdg, pdh0, pdc0])
        held["lstm_chain"].add((t, bt, h, g, mix))
        bf = tc == tw == "bf16"
        mm = 2.0 * t * bt * h * g * h
        f32_shape = f"G={g} [T {t}, B {bt}, H {h}]"
        lib = lib_b = None
        if g == 4 and bf:
            cols = torch.cat([torch.arange(j * h, (j + 1) * h, device=dev)
                              for j in (0, 1, 3, 2)])
            lstm = torch.nn.LSTM(d, h).to(dev, torch.bfloat16)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(w[:d, cols].t())
                lstm.weight_hh_l0.copy_(w[d:, cols].t())
                lstm.bias_ih_l0.copy_(bias[cols])
                lstm.bias_hh_l0.zero_()
            xb = x.to(torch.bfloat16)

            def lib(lstm=lstm, xb=xb, h0c=h0c, c0c=c0c):
                with torch.no_grad():
                    return lstm(xb, (h0c[None], c0c[None]))

            # its backward in bf16 over the same steps for the same upstream
            # dhs (it also computes dx and dW_ih, which the chain leaves
            # out), as the f32 backward's reading
            lx = xb.detach().requires_grad_()
            lh0, lc0 = (z[None].detach().requires_grad_() for z in (h0c, c0c))
            lout, _ = lstm(lx, (lh0, lc0))

            def lib_b(lstm=lstm, lout=lout, lx=lx, lh0=lh0, lc0=lc0, g_=chc):
                return torch.autograd.grad(
                    lout, (lx, lh0, lc0, *lstm.parameters()), g_,
                    retain_graph=True)
        rows["fwd"].append(row(
            f"lstm_chain_fwd {shape}",
            lambda: lb.chain_fwd(xc, h0c, c0c, w_hh, maxout=maxout),
            lambda: lo.chain_fwd_plain(xc, h0c, c0c, w_hh, maxout=maxout),
            "chain_fwd_kernel", nbytes(xc, h0c, c0c, w_hh, hs, cs, gates),
            0.0 if bf else mm, mm if bf else 0.0, e_f, lib=lib,
            f32_ms=f32_chain["fwd"].get(f32_shape)))
        rows["bwd"].append(row(
            f"lstm_chain_bwd {shape}",
            lambda: lb.chain_bwd(gates, cs, c0c, chc, ccc, w_hh,
                                 maxout=maxout),
            lambda: lo.chain_bwd_plain(gates, cs, c0c, chc, ccc, w_hh,
                                       maxout=maxout),
            "chain_bwd_kernel",
            nbytes(gates, cs, c0c, chc, ccc, w_hh, dg, dh0, dc0),
            0.0 if tw == "bf16" else mm, mm if tw == "bf16" else 0.0, e_b,
            lib=lib_b, f32_ms=f32_chain["bwd"].get(f32_shape)))
    for key, line in (("fwd", "52"), ("bwd", "120")):
        rec[f"lstm_chain_{key}_bf16"] = _bf16_record(
            f"lstm_chain_{key}_bf16",
            "unpaired_image_captioning_tpu_torch/csrc/lstm_block.cu",
            f"lstm_block.py:{line}", rows[key])
    return rec, held


# ---------------------------------------------------------------------------
# the compute dtype, second part (A15): the bf16 entries of the transformer
# kernels B4-B8 and B11, and the bf16 transformer path on the card
# ---------------------------------------------------------------------------

# the CUDA kernels the typed (bf16) instances launch, by name
TF_TRAIN_KERNELS = TRAIN_KERNELS + ("ln_fwd_typed_kernel",
                                    "train_gemm_bf16_kernel",
                                    "drop4_bf16_kernel") + (
                                    MHA_TC_FWD_KERNELS + MHA_TC_BWD_KERNELS)
TF_TFD_KERNELS = TFD_KERNELS + ("ln_rows_typed_kernel",)
# B8 (x, scale / offset): the cast route, and JAX's default config on the
# CPU (bf16 features through f32 parameters; the kernel takes it too)
BF16_LN_MIXES = (("bf16", "bf16"), ("bf16", "f32"))
BF16_LN_SHAPES = [("captioner encoder", 50, 196, 512),
                  ("captioner decoder", 50, 17, 512),
                  ("transformer NMT", 50, NMT_SRC_LEN, 512)]
# B5 at the training steps' shapes (label, B, T, S, mask kind, d, heads)
BF16_MHA_SHAPES = [
    ("encoder self, T = S = 196, padded [B,1,S]", 50, 196, 196, "pad"),
    ("decoder cross, T = 17, S = 196", 50, 17, 196, "pad"),
    ("decoder self, T = S = 17, causal + pad [B,T,T]", 50, 17, 17, "causal"),
    ("NMT encoder self, T = S = 16", 50, NMT_SRC_LEN, NMT_SRC_LEN, "pad"),
    ("NMT decoder cross, T = 17, S = 16", 50, 17, NMT_SRC_LEN, "pad")]
# B5's tensor-core instance at ragged shapes, held and not timed: (B, T, S,
# mask kind, d, heads): heads of 32, 96 (padded in bucket 128), 128 and 256
# columns, T and S off the 64-row tiles, one key
BF16_MHA_RAGGED = [(3, 65, 196, "pad", 64, 2), (3, 17, 1, "pad", 192, 2),
                   (2, 65, 65, "causal", 256, 2), (2, 33, 33, "causal", 256,
                                                   1)]
# B6 (label, B, T, d, d_ff, heads) and B7 (label, B, T, S, d, d_ff, heads)
BF16_ENC_SHAPES = [("captioner encoder", 50, 196, 512, 512, 8),
                   ("transformer NMT encoder", 50, NMT_SRC_LEN, 512, 2048, 8)]
BF16_DEC_SHAPES = [("captioner decoder", 50, 17, 196, 512, 512, 8)]
# B6 / B7's tensor-core GEMMs at ragged shapes, held and not timed: rows not
# a multiple of 128, widths multiples of 8 but not 16, and widths not
# multiples of 8 (element copies, `one` epilogues); (B, T, d, d_ff, heads)
# and (B, T, S, d, d_ff, heads)
BF16_ENC_RAGGED = [(3, 29, 40, 72, 5), (3, 29, 30, 45, 5),
                   (2, 19, 100, 200, 2)]
BF16_DEC_RAGGED = [(3, 9, 70, 40, 72, 5), (3, 9, 70, 30, 45, 5)]
# B4 (x, weights, caches, memory) on the routes: the card's serving and
# eval of rounded features (f32 weights, bf16 memory and caches), and the
# SCST sample under the cast route's bf16 copies (every operand bf16)
BF16_TFD_MIXES = (("f32", "f32", "bf16", "bf16"),
                  ("bf16", "bf16", "bf16", "bf16"))
BF16_TFD_SHAPES = [TFD_SHAPES[0], TFD_SHAPES[2]]   # beam 5 x 50, batch 50
# B11 with a bf16 store: the loader's identity size (bit for bit) and the
# downscale
BF16_IMG_CASES = IMG_CASES[:2]


def _scaled_errs(name: str, got, want) -> list:
    """max|kernel - plain| / max(1, max|plain|) of each output, types and
    shapes equal, without a bound."""
    errs = []
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: kernel {a.dtype} {tuple(a.shape)}"
                                 f" against plain {b.dtype} {tuple(b.shape)}")
        a, b = a.float(), b.float()
        errs.append((a - b).abs().max().item()
                    / max(1.0, b.abs().max().item()) if b.numel() else 0.0)
    return errs


def _bf16_scaled(name: str, got, want) -> float:
    """Each output: max|kernel - plain| <= BF16_TOL * max(1, max|plain|),
    types equal; returns the largest of those ratios. The bf16 check of
    the attention, the whole layers and the decoder step: their residual
    streams and sums hold bf16 values of magnitude 4-30, 2^-5 to 2^-3
    apart, so one rounding that a sum in another order takes the other way
    moves an element past an elementwise atol of 1e-2 wherever the output
    cancels to near 0 (tests/test_torch_dtype_transformer.py)."""
    errs = _scaled_errs(name, got, want)
    for e in errs:
        if not e <= BF16_TOL:
            raise AssertionError(f"{name}: max|diff| / max(1, max|plain|) "
                                 f"{e:.4g} > {BF16_TOL}")
    return max(errs, default=0.0)


# ROADMAP C5: the all-bf16 stack step at BF16_TFD_SHAPES[0] at draws of its
# own (each seed its own generator, so no other check's draw moves)
C5_SEEDS = tuple(range(2500, 2508))


def _c5_check(dev) -> dict:
    """ROADMAP C5: B4's all-bf16 step at the caption beam's shape
    (BF16_TFD_SHAPES[0]) at each of C5_SEEDS, held layer by layer and read
    as a whole stack. Layer l of the kernel (`decoder_layer_step`, the same
    typed layer code the stack runs) and `decoder_layer_step_plain` take
    the same inputs, x being the plain output of layer l-1 in its type, so
    each layer's difference is that layer's own: every output of every
    layer must hold at BF16_TOL of its scale, else the kernel departs from
    its plain version. The whole stack (kernel against plain, six layers of
    compounding) is read and recorded, not bounded here: the script's own
    draw holds it at BF16_TOL in `_tf_check`. Returns the maxima."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops import (
        transformer_decode as tdo)

    label, b, kb, n_l, n_t, slots, d, dff, heads, lazy = BF16_TFD_SHAPES[0]
    bf = torch.bfloat16
    kw = dict(n_heads=heads)
    outs = ("x", "cache_k", "cache_v")
    per_layer = [[0.0] * 3 for _ in range(n_l)]
    stacks = []
    with torch.no_grad():
        for seed in C5_SEEDS:
            a = _tfd_inputs(dev, torch.Generator(device=dev).manual_seed(seed),
                            b, kb, n_l, n_t, slots, d, dff, lazy)
            w = {k: v.to(bf) for k, v in a["w"].items()}
            x, kc, vc = a["x"].to(bf), a["kc"].to(bf), a["vc"].to(bf)
            ck, cv = a["ck"].to(bf), a["cv"].to(bf)
            sargs = (x, a["t"], ck, cv, a["mask"], kc, vc, w, a["anc"])
            got = tdk.decoder_stack_step(*_clone(sargs), **kw)
            want = tdo.decoder_stack_step_plain(*_clone(sargs), **kw)
            stacks.append(_scaled_errs("C5 stack", got, want))
            xin = x
            for l in range(n_l):
                largs = (xin, a["t"], ck[l].contiguous(), cv[l].contiguous(),
                         a["mask"], kc[:, l].contiguous(),
                         vc[:, l].contiguous(),
                         {k: v[l].contiguous() for k, v in w.items()})
                got = tdk.decoder_layer_step(*_clone(largs), **kw)
                want = tdo.decoder_layer_step_plain(*_clone(largs), **kw)
                errs = _scaled_errs(f"C5 layer {l}", got, want)
                per_layer[l] = [max(p, e) for p, e in zip(per_layer[l], errs)]
                if max(errs) > BF16_TOL:
                    raise AssertionError(
                        f"C5: layer {l} alone at seed {seed} departs from its "
                        f"plain version: {dict(zip(outs, errs))} > {BF16_TOL}"
                        " of each output's scale")
                xin = want[0]
    torch.cuda.synchronize()
    worst = [max(s[i] for s in stacks) for i in range(3)]
    log(f"C5, B4 all bf16 [{label}] at seeds {C5_SEEDS[0]}..{C5_SEEDS[-1]}: "
        "each layer alone, max over the seeds of max|kernel - plain| / "
        "max(1, max|plain|) (x, cache_k, cache_v): " + "; ".join(
            f"layer {l} " + "/".join(f"{e:.4g}" for e in p)
            for l, p in enumerate(per_layer))
        + f" (held at {BF16_TOL}); the whole stack by seed (x): "
        + ", ".join(f"{s[0]:.4g}" for s in stacks)
        + f"; max " + "/".join(f"{e:.4g}" for e in worst)
        + f"; past {BF16_TOL}: {sum(max(s) > BF16_TOL for s in stacks)} of "
        f"{len(stacks)} seeds")
    return {"seeds": list(C5_SEEDS), "layer_max": per_layer,
            "stack_by_seed": stacks, "stack_max": worst}


def _tf_mix(*ts) -> tuple:
    return tuple(_mix_name([t.dtype]) for t in ts)


def _tf_key(kind: str, a: tuple, kw: dict):
    """The (shape, mixture) key of one call of a transformer kernel's
    wrapper, as `phase_bf16_tf_kernels` holds them."""
    if kind in ("ln_train_fwd", "ln_train_bwd"):
        x, scale = a[0], a[1]
        return (tuple(x.shape), _tf_mix(x, scale))
    if kind in ("mha_train_fwd", "mha_train_bwd"):
        q, k, _, maskadd = a[:4]
        return (tuple(q.shape), k.shape[1], maskadd.shape[1],
                kw["n_heads"], kw["rate"], _tf_mix(q))
    if kind in ("enc_layer_fwd", "enc_layer_bwd"):
        x, w = a[0], a[3]
        return (tuple(x.shape), w["w1"].shape[1], kw["n_heads"], kw["rate"],
                _tf_mix(x, w["wqkv"]))
    if kind in ("dec_layer_fwd", "dec_layer_bwd"):
        x, mk, w = a[0], a[1], a[6]
        return (tuple(x.shape), mk.shape[1], w["w1"].shape[1],
                kw["n_heads"], kw["rate"], _tf_mix(x, w["wqkv"]))
    if kind in ("decoder_stack_step", "decoder_layer_step"):
        x, ck, cache_k, w = a[0], a[2], a[5], a[7]
        return (x.shape[0], tuple(ck.shape), tuple(cache_k.shape),
                w["w1"].shape[-1], kw["n_heads"], a[8] is not None
                if len(a) > 8 else False,
                _tf_mix(x, w["wqkv"], cache_k, ck))
    return (tuple(a[0].shape), kw.get("h_out", 448), kw.get("w_out", 448),
            (_mix_name([kw.get("out_dtype", "f32")]),))


def _tf_sites():
    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    from unpaired_image_captioning_tpu_torch.models import (
        nmt_transformer, transformer)

    # the decoder step where the models call it (they import it by name)
    return [(lnk, "ln_train_fwd"), (lnk, "ln_train_bwd"),
            (mhk, "mha_train_fwd"), (mhk, "mha_train_bwd"),
            (ltk, "enc_layer_fwd"), (ltk, "enc_layer_bwd"),
            (ltk, "dec_layer_fwd"), (ltk, "dec_layer_bwd"),
            (tdk, "decoder_stack_step"), (tdk, "decoder_layer_step"),
            (transformer, "decoder_stack_step"),
            (transformer, "decoder_layer_step"),
            (nmt_transformer, "decoder_stack_step"),
            (imk, "resize_normalize")]


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    return v


class _recording_tf:
    """While open, every CUDA call of a transformer kernel's wrapper (B4-B8,
    B11) adds its (shape, mixture) key to `seen[kind]` and keeps a copy of
    the arguments of the first call of each key that `held` does not hold,
    so that `_hold_tf` can hold the kernel against its plain version on
    those very inputs."""

    def __init__(self, seen: dict, args: dict, held: dict):
        self._seen, self._args, self._held = seen, args, held
        self.calls = {}     # (kind, key) -> calls on the card

    def __enter__(self):
        self._saved = []
        for mod, attr in _tf_sites():
            fn = getattr(mod, attr)

            def call(*a, _fn=fn, _kind=attr, **kw):
                if a[0].device.type == "cuda":
                    key = _tf_key(_kind, a, kw)
                    self._seen.setdefault(_kind, set()).add(key)
                    self.calls[(_kind, key)] = self.calls.get(
                        (_kind, key), 0) + 1
                    if (key not in self._held.get(_kind, ())
                            and (_kind, key) not in self._args):
                        self._args[(_kind, key)] = (_clone(a), dict(kw))
                return _fn(*a, **kw)

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, call)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def _tf_check(kind: str, a: tuple, kw: dict, bf: bool) -> float:
    """One call of `kind` on the arguments a against its plain version:
    bf16 at BF16_TOL (each output in its own type), all f32 at the f32
    phases' tolerances. Returns the error."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops import image as imo
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto
    from unpaired_image_captioning_tpu_torch.ops import ln_train as lno
    from unpaired_image_captioning_tpu_torch.ops import mha_train as mho
    from unpaired_image_captioning_tpu_torch.ops import (
        transformer_decode as tdo)

    def close(got, want, tol=TRAIN_TOL):
        got, want = list(got), list(want)
        name = f"{kind} {_tf_key(kind, a, kw)}"
        if bf and kind in ("ln_train_fwd", "ln_train_bwd",
                           "resize_normalize"):
            return _bf16_close(name, got, want)
        if bf:
            return _bf16_scaled(name, got, want)
        return _check_each(name, ["out"] * len(got), got, want, tol)

    with torch.no_grad():
        if kind == "ln_train_fwd":
            return close([lnk.ln_train_fwd(*a, **kw)],
                         [lno.ln_train_plain(*a, **kw)])
        if kind == "ln_train_bwd":
            return close(lnk.ln_train_bwd(*a, **kw),
                         lno.ln_train_plain_bwd(*a, **kw))
        if kind == "mha_train_fwd":
            out, stats = mhk.mha_train_fwd(*a, **kw)
            return close([out, stats],
                         [mho.mha_train_plain(*a, **kw),
                          mho.softmax_stats(a[0], a[1], a[3],
                                            n_heads=kw["n_heads"])])
        if kind == "mha_train_bwd":
            return close(mhk.mha_train_bwd(*a, **kw),
                         mho.mha_train_plain_bwd(*a[:6], **kw))
        if kind == "enc_layer_fwd":
            x, maskadd, seed, w = a
            out, saved = ltk.enc_layer_fwd(*a, **kw)
            ref, x2 = lto.enc_fwd_plain(x, maskadd, seed, *(
                w[k] for k in lto.ENC_WEIGHTS), **kw)
            return close([out, saved[0]], [ref, x2.to(saved[0].dtype)])
        if kind == "enc_layer_bwd":
            x, maskadd, seed, w, saved, g = a
            got = ltk.enc_layer_bwd(*a, **kw)
            want = lto.enc_bwd_plain(
                x, maskadd, seed, saved[0].to(x.dtype), g,
                *(w[k] for k in lto.ENC_WEIGHTS), **kw,
                relu_active=saved[-1] > 0)
            return close(got, want)
        if kind == "dec_layer_fwd":
            x, mk, mv, tm, sm, seeds, w = a
            out, saved = ltk.dec_layer_fwd(*a, **kw)
            ref, x2, x3 = lto.dec_fwd_plain(x, mk, mv, tm, sm, seeds, *(
                w[k] for k in lto.DEC_WEIGHTS), **kw)
            return close([out, saved[0], saved[1]],
                         [ref, x2.to(saved[0].dtype), x3.to(saved[1].dtype)])
        if kind == "dec_layer_bwd":
            x, mk, mv, tm, sm, seeds, w, saved, g = a
            got = ltk.dec_layer_bwd(*a, **kw)
            want = lto.dec_bwd_plain(
                x, mk, mv, tm, sm, seeds, saved[0].to(x.dtype),
                saved[1].to(x.dtype), g, *(w[k] for k in lto.DEC_WEIGHTS),
                **kw, relu_active=saved[-1] > 0)
            return close(got, want)
        if kind in ("decoder_stack_step", "decoder_layer_step"):
            k_args, p_args = list(_clone(a)), list(_clone(a))
            fn = (tdk.decoder_stack_step if kind == "decoder_stack_step"
                  else tdk.decoder_layer_step)
            pfn = (tdo.decoder_stack_step_plain
                   if kind == "decoder_stack_step"
                   else tdo.decoder_layer_step_plain)
            got, want = fn(*k_args, **kw), pfn(*p_args, **kw)
            if bf:
                return close(got, want)
            e = _rel_err(got, want)
            if not e <= TFD_TOL:
                raise AssertionError(f"{kind}: {e} > {TFD_TOL}")
            return e
        got = imk.resize_normalize(*a, **kw)
        want = imo.resize_normalize_plain(a[0], **kw)
        return close([got], [want], IMG_TOL)


def _hold_tf(args: dict) -> dict:
    """Each recorded call `_recording_tf` kept, held against the plain
    version on its own inputs; returns {kind: keys held here}."""
    import torch

    done = {}
    for (kind, key), (a, kw) in sorted(args.items(), key=str):
        _tf_check(kind, a, kw, "bf16" in key[-1])
        done.setdefault(kind, []).append(key)
    torch.cuda.synchronize()
    args.clear()
    return done


def _tc_layer_check(kind: str, fargs: tuple, g, kw: dict) -> tuple:
    """One bf16 whole-layer call each way on the tensor cores (`kind` "enc"
    or "dec"): held against the plain version (`_tf_check`), the backward
    run twice with the same bits, each call counted by the wrapper's
    tensor-core counter. Returns (out, saved, grads, forward error,
    backward error, the backward's arguments)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk

    fwd, bwd = getattr(ltk, f"{kind}_layer_fwd"), getattr(ltk,
                                                         f"{kind}_layer_bwd")
    names = (f"tc_{kind}_fwd_launches", f"tc_{kind}_bwd_launches")
    before = [getattr(ltk, n) for n in names]
    e_f = _tf_check(f"{kind}_layer_fwd", fargs, kw, True)
    out, saved = fwd(*fargs, **kw)
    bargs = fargs + (saved, g)
    e_b = _tf_check(f"{kind}_layer_bwd", bargs, kw, True)
    grads = bwd(*bargs, **kw)
    again = bwd(*bargs, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{kind}_layer_bwd bf16 "
                             f"{_tf_key(kind + '_layer_bwd', bargs, kw)}: a "
                             "rerun differs")
    got = [getattr(ltk, n) - b for n, b in zip(names, before)]
    if got != [2, 3]:
        raise AssertionError(f"{kind} layer bf16: {got} tensor-core "
                             "launches (forward, backward), expected [2, 3]")
    return out, saved, grads, e_f, e_b, bargs


def _tc_mha_check(fargs: tuple, g, kw: dict) -> tuple:
    """One all-bf16 B5 call each way on the tensor-core instance: held
    against the plain version (`_tf_check`), the backward run twice with the
    same bits, each call counted by `tc_fwd_launches` / `tc_bwd_launches`
    and the instance's CUDA kernels the ones the profiler saw. Returns
    (out, stats, grads, forward error, backward error, the backward's
    arguments)."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk

    q, heads = fargs[0], kw["n_heads"]
    name = f"mha_train bf16 {_tf_key('mha_train_fwd', fargs, kw)}"
    if not mhk.tensor_core(q.dtype, q.shape[-1] // heads):
        raise AssertionError(f"{name}: not a tensor-core shape")
    before = (mhk.tc_fwd_launches, mhk.tc_bwd_launches)
    e_f = _tf_check("mha_train_fwd", fargs, kw, True)
    out, stats = mhk.mha_train_fwd(*fargs, **kw)
    bargs = fargs + (g, out, stats)
    e_b = _tf_check("mha_train_bwd", bargs, kw, True)
    grads = mhk.mha_train_bwd(*bargs, **kw)
    again = mhk.mha_train_bwd(*bargs, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: a rerun of the backward differs")
    got = [mhk.tc_fwd_launches - before[0], mhk.tc_bwd_launches - before[1]]
    if got != [2, 3]:
        raise AssertionError(f"{name}: {got} tensor-core launches (forward, "
                             "backward), expected [2, 3]")
    # the kernels the profiler saw (a session may lose some of its first
    # events, never invent one): tensor-core kernels, and none of the FMA
    # core's
    per_name = _profile_device_us(lambda: mhk.mha_train_bwd(*bargs, **kw))
    seen = sorted(per_name or ())
    fma = [n for n in seen if "mha_" in n and "_tc_kernel" not in n]
    if seen and (fma or not any(
            k in n for n in seen for k in MHA_TC_BWD_KERNELS)):
        raise AssertionError(f"{name}: the backward ran {seen}, not "
                             f"{MHA_TC_BWD_KERNELS}")
    return out, stats, grads, e_f, e_b, bargs


def _b4_bf16_cases(dev, gen, mixes):
    """B4 at the path pairs (BF16_TFD_SHAPES) in each of `mixes`, the stack
    and one layer of each, on `_tfd_inputs` drawn once a shape from `gen`:
    dicts of the record's name, the wrapper (`kind`), its arguments and
    keywords, the bytes at the arrays' own element sizes (the weights, x in
    and out, the positions read and written, the memory) and the operations
    this data needs, the route `tdk.route` names (None on a tree without
    it) and, where every operand is bf16, the step's products alone in bf16
    cuBLAS (`lib`). Only the wrappers are called, so that `--times bf16`
    reads an older tree's kernels the same way."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    for label, b, kb, n_l, n_t, slots, d, dff, heads, lazy in BF16_TFD_SHAPES:
        a = _tfd_inputs(dev, gen, b, kb, n_l, n_t, slots, d, dff, lazy)
        r_ = b * kb
        pos = int((a["t"].long() + 1).sum())
        cross = int(a["mask"].sum(1).repeat_interleave(kb).sum())
        for mix in mixes:
            tx, tw, tc, tm = (_dt(z) for z in mix)
            w = {k_: v_.to(tw) for k_, v_ in a["w"].items()}
            w0 = {k_: v_[0].contiguous() for k_, v_ in w.items()}
            x = a["x"].to(tx)
            kc, vc = a["kc"].to(tc), a["vc"].to(tc)
            ck, cv = a["ck"].to(tm), a["cv"].to(tm)
            sargs = (x, a["t"], ck, cv, a["mask"], kc, vc, w, a["anc"])
            largs = (x, a["t"], ck[0].contiguous(), cv[0].contiguous(),
                     a["mask"], kc[:, 0].contiguous(), vc[:, 0].contiguous(),
                     w0)
            all_bf = mix == ("bf16",) * 4
            fl = sum(f for f, m in zip((1, 2, 4, 8), mix) if m == "bf16")
            rule = getattr(tdk, "route", None)
            for name, kind, args_, layers, ws_ in (
                    ("transformer_decode_stack_bf16", "decoder_stack_step",
                     sargs, n_l, w), ("transformer_decode_layer_bf16",
                                      "decoder_layer_step", largs, 1, w0)):
                nb = (nbytes(*ws_.values()) + 2 * nbytes(x)
                      + nbytes(a["t"], a["mask"])
                      + layers * (kc.element_size() * (2 * pos * d
                                                       + 2 * r_ * d)
                                  + ck.element_size() * 2 * b * slots * d))
                flops = layers * (2.0 * r_ * (6 * d * d + 2 * d * dff)
                                  + 4.0 * d * pos + 4.0 * d * cross)
                lib = None
                if all_bf:
                    wb = ws_ if layers > 1 else {k_: v_[None] for k_, v_ in
                                                 ws_.items()}
                    gen2 = torch.Generator(device=dev).manual_seed(2)
                    act = torch.randn((r_, max(d, dff)), generator=gen2,
                                      device=dev).to(torch.bfloat16)
                    y_, h1_ = act[:, :d].contiguous(), act[:, :dff].contiguous()

                    def lib(wb=wb, y_=y_, h1_=h1_):
                        for l_ in range(wb["wqkv"].shape[0]):
                            torch.matmul(y_, wb["wqkv"][l_])
                            torch.matmul(y_, wb["wo_s"][l_])
                            torch.matmul(y_, wb["wq_c"][l_])
                            torch.matmul(y_, wb["wo_c"][l_])
                            torch.matmul(y_, wb["w1"][l_])
                            torch.matmul(h1_, wb["w2"][l_])
                mix_s = "x/w/caches/memory " + "/".join(mix)
                yield dict(
                    name=name, kind=kind, args=args_, kw=dict(n_heads=heads),
                    layers=layers, bytes=nb, flops=flops, all_bf=all_bf,
                    lib=lib, mix=mix, shape_label=label,
                    label=(f"R={r_} kb={kb} L={layers} T={n_t} S={slots} "
                           f"d={d} {mix_s} ({label})"),
                    route=None if rule is None else rule(
                        fl, d, dff, heads, n_t, slots))


def _tfd_tc_check(case) -> None:
    """One call of a B4 bf16 case: the path's mixtures take the fast
    attentions (every bf16 mixture at these shapes), an all-bf16 step the
    tensor cores too, by the rule (`tdk.route`), and the call counts one
    tensor-core launch exactly where the rule names them (the wrapper
    raises where the route the C side ran differs from the rule)."""
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)

    want = tdk.ROUTE_SELF | tdk.ROUTE_CROSS
    if case["all_bf"]:
        want |= tdk.ROUTE_TC
    if case["route"] != want:
        raise AssertionError(f"{case['name']} [{case['label']}]: the rule "
                             f"names route {case['route']}, not {want}")
    counter = ("tc_stack_launches" if case["kind"] == "decoder_stack_step"
               else "tc_layer_launches")
    before = getattr(tdk, counter)
    getattr(tdk, case["kind"])(*_clone(case["args"]), **case["kw"])
    got = getattr(tdk, counter) - before
    if got != int(case["all_bf"]):
        raise AssertionError(f"{case['name']} [{case['label']}]: {got} "
                             "tensor-core launches for one call")


def phase_bf16_tf_kernels(dev, kernels: dict) -> tuple:
    """The bf16 entries of the transformer kernels (B4-B8) and of B11
    against their plain versions on the card at the path shapes, in every
    mixture the routes give them, each timed beside the f32 entry at the
    same shape, its bound at 2 bytes a bf16 element and the products of
    two bf16 operands at the bf16 tensor-core rate; the library call
    beside it where one computes the function: SDPA on bf16 tensors (B5),
    the step's GEMMs alone in bf16 cuBLAS (B4, B6, B7), F.interpolate
    (B11, the resize alone). Returns (the JSON records, the held keys
    {wrapper: {key}})."""
    import torch
    import torch.nn.functional as F

    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.ops import image as imo
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto
    from unpaired_image_captioning_tpu_torch.ops import ln_train as lno
    from unpaired_image_captioning_tpu_torch.ops import mha_train as mho
    from unpaired_image_captioning_tpu_torch.ops import (
        transformer_decode as tdo)

    gen = torch.Generator(device=dev).manual_seed(22)
    bf = torch.bfloat16
    rows = {}
    held = {}

    def f32_of(name, label):
        for r in kernels.get(name, {}).get("shapes", []):
            lab = r.get("label", "") + " " + str(r.get("shape", ""))
            if label in lab:
                return r["ms"]
        return None

    def row(name, label, kfn, pfn, names, by, f32_flops, bf16_flops, err,
            lib=None, lib_what="none", f32_ms=None, iters=BF16_ITERS):
        k_ms, p_ms, k_wall, p_wall, how = time_pair(kfn, pfn, names,
                                                    iters=iters)
        b_ms, term = bound_mixed(by, f32_flops, bf16_flops)
        lib_ms = library_ms(lib, iters=iters)[0] if lib is not None else None
        fmt = (lambda v: "none" if v is None else f"{v:.4f} ms")
        log(f"kernel {name} [{label}]: |diff| / (1 + |plain|) {err:.3g} "
            f"(held at rtol = atol = {BF16_TOL}); {how}: kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.4f} ms; per call {k_wall:.4f} / {p_wall:.4f} "
            f"ms; bound {b_ms:.4f} ms ({term}; bf16 elements 2 bytes); f32 "
            f"entry {fmt(f32_ms)}; library {lib_what} {fmt(lib_ms)}")
        rows.setdefault(name, []).append(dict(
            label=label, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by="bytes" if term == "bytes" else "operations",
            bound_term=term, library_ms=lib_ms, library_is=lib_what,
            wall_ms=k_wall, plain_wall_ms=p_wall, timing=how, err=err,
            f32_entry_ms=f32_ms))

    def hold(kind, a, kw):
        held.setdefault(kind, set()).add(_tf_key(kind, a, kw))

    # B8
    for label, b, t, d in BF16_LN_SHAPES:
        x, scale, offset, g = _ln_inputs(dev, gen, b, t, d)
        for mx, mp in BF16_LN_MIXES:
            args = (x.to(_dt(mx)), scale.to(_dt(mp)), offset.to(_dt(mp)))
            bargs = (args[0], args[1], g.to(_dt(mx)))
            e_f = _tf_check("ln_train_fwd", args, {}, True)
            e_b = _tf_check("ln_train_bwd", bargs, {}, True)
            hold("ln_train_fwd", args, {})
            hold("ln_train_bwd", bargs, {})
            y = lnk.ln_train_fwd(*args)
            grads = lnk.ln_train_bwd(*bargs)
            shape = f"[{b}, {t}, {d}] x/params {mx}/{mp} ({label})"
            n = float(b * t * d)
            row("ln_train_fwd_bf16", shape, lambda a_=args: lnk.ln_train_fwd(
                *a_), lambda a_=args: lno.ln_train_plain(*a_),
                ("ln_fwd_typed_kernel",), nbytes(*args, y), 8.0 * n, 0.0,
                e_f, f32_ms=f32_of("ln_train_fwd", f"[{b}, {t}, {d}]"),
                lib_what="none (F.layer_norm: other formula)")
            row("ln_train_bwd_bf16", shape, lambda a_=bargs:
                lnk.ln_train_bwd(*a_), lambda a_=bargs:
                lno.ln_train_plain_bwd(*a_), LN_BWD_KERNELS,
                nbytes(*bargs, *grads), 14.0 * n, 0.0, e_b,
                f32_ms=f32_of("ln_train_bwd", f"[{b}, {t}, {d}]"),
                lib_what="none (F.layer_norm: other formula)")

    # B5: every path shape on the tensor-core instance, then ragged shapes
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    for label, b, t, s, kind in BF16_MHA_SHAPES:
        d, heads = TCAP["input_encoding_size"], TCAP["num_heads"]
        q, k, v, g, maskadd = _mha_inputs(dev, gen, b, t, s, kind, d)
        q, k, v, g = (z.to(bf) for z in (q, k, v, g))
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (q, k, v, maskadd, seed)
        out, stats, grads, e_f, e_b, bargs = _tc_mha_check(fargs, g, kw)
        hold("mha_train_fwd", fargs, kw)
        hold("mha_train_bwd", bargs, kw)
        dh = d // heads
        pairs = float((maskadd >= 0).expand(b, t, s).sum()) * heads
        q4, k4, v4, g4 = (z.view(b, z.shape[1], heads, dh).transpose(1, 2)
                          for z in (q, k, v, g))
        m4 = maskadd[:, None].to(bf)
        lq, lk_, lv = (z.detach().requires_grad_() for z in (q4, k4, v4))
        lout = F.scaled_dot_product_attention(lq, lk_, lv, attn_mask=m4)
        shape = f"B={b} T={t} S={s} d={d} H={heads} bf16 ({label})"
        row("mha_train_fwd_bf16", shape,
            lambda: mhk.mha_train_fwd(*fargs, **kw),
            lambda: mho.mha_train_plain(*fargs, **kw), MHA_TC_FWD_KERNELS,
            nbytes(*fargs, out, stats), 0.0, 4.0 * pairs * dh, e_f,
            lib=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=m4),
            lib_what="scaled_dot_product_attention bf16, rate 0",
            f32_ms=f32_of("mha_train_fwd", label.split(",")[0]))
        row("mha_train_bwd_bf16", shape,
            lambda: mhk.mha_train_bwd(*bargs, **kw),
            lambda: mho.mha_train_plain_bwd(*bargs[:6], **kw),
            MHA_TC_BWD_KERNELS, nbytes(*bargs, *grads), 0.0,
            10.0 * pairs * dh, e_b,
            lib=lambda: torch.autograd.grad(lout, (lq, lk_, lv), g4,
                                            retain_graph=True),
            lib_what="scaled_dot_product_attention bf16 backward, rate 0",
            f32_ms=f32_of("mha_train_bwd", label.split(",")[0]))
        del lout, lq, lk_, lv
    # their own generator: the checks after them draw what they drew
    # before these were added
    gen_r = torch.Generator(device=dev).manual_seed(24)
    for b, t, s_, kind, d, heads in BF16_MHA_RAGGED:
        q, k, v, g, maskadd = _mha_inputs(dev, gen_r, b, t, s_, kind, d)
        q, k, v, g = (z.to(bf) for z in (q, k, v, g))
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (q, k, v, maskadd, seed)
        *_, e_f, e_b, bargs = _tc_mha_check(fargs, g, kw)
        hold("mha_train_fwd", fargs, kw)
        hold("mha_train_bwd", bargs, kw)
        log(f"kernel mha_train bf16 [B={b} T={t} S={s_} {kind} dh "
            f"{d // heads}] (ragged): forward {e_f:.3g}, backward {e_b:.3g} "
            f"of each tensor's scale (held at {BF16_TOL}); the backward twice "
            "bit for bit; on the tensor cores")

    # B6
    for label, b, t, d, f, heads in BF16_ENC_SHAPES:
        x, g, _, maskadd, seed_l, w, pad = _enc_layer_inputs(dev, gen, b, t,
                                                             d, f)
        x, g = x.to(bf), g.to(bf)
        w = {k_: v_.to(bf) for k_, v_ in w.items()}
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (x, maskadd, seed_l, w)
        out, saved, grads, e_f, e_b, bargs = _tc_layer_check("enc", fargs,
                                                             g, kw)
        hold("enc_layer_fwd", fargs, kw)
        hold("enc_layer_bwd", bargs, kw)
        ws = [w[k_] for k_ in lto.ENC_WEIGHTS]
        m = b * t
        acts = {"y1": saved[1].reshape(m, d).to(bf),
                "ao": saved[3].reshape(m, d).to(bf),
                "y2": saved[5].reshape(m, d).to(bf),
                "hd": saved[6].reshape(m, f).to(bf)}
        g_fwd, g_bwd = _layer_gemms(acts, w, decoder=False)
        g_bwd = [(a_.to(bf), b_.to(bf)) for a_, b_ in g_bwd]
        log(f"enc_layer_train bf16 [{label}]: the tensor-core GEMM plans "
            + _gemm_plans(g_fwd + g_bwd, 1))
        pairs = float((maskadd >= 0).expand(b, t, t).sum()) * heads
        proj = float(m) * (4 * d * d + 2 * d * f)
        dh = d // heads
        shape = f"B={b} T={t} d={d} d_ff={f} H={heads} bf16 ({label})"
        row("enc_layer_train_fwd_bf16", shape,
            lambda: ltk.enc_layer_fwd(*fargs, **kw),
            lambda: lto.enc_fwd_plain(x, maskadd, seed_l, *ws, **kw),
            TF_TRAIN_KERNELS, nbytes(x, maskadd, seed_l, *ws, out),
            0.0, 2.0 * proj + 4.0 * pairs * dh, e_f, iters=5,
            lib=lambda: [torch.matmul(a_, b_) for a_, b_ in g_fwd],
            lib_what="its products alone, bf16 cuBLAS",
            f32_ms=f32_of("enc_layer_train_fwd", label))
        row("enc_layer_train_bwd_bf16", shape,
            lambda: ltk.enc_layer_bwd(*bargs, **kw),
            lambda: lto.enc_bwd_plain(x, maskadd, seed_l,
                                      saved[0].to(bf), g, *ws, **kw),
            TF_TRAIN_KERNELS, nbytes(x, maskadd, seed_l, *ws, g, *grads),
            0.0, 4.0 * proj + 10.0 * pairs * dh, e_b, iters=5,
            lib=lambda: [torch.matmul(a_, b_) for a_, b_ in g_bwd],
            lib_what="its products alone, bf16 cuBLAS",
            f32_ms=f32_of("enc_layer_train_bwd", label))
        del out, saved, grads, acts, g_fwd, g_bwd

    # B7
    for label, b, t, s, d, f, heads in BF16_DEC_SHAPES:
        x, g = (torch.randn((b, t, d), generator=gen, device=dev).to(bf)
                for _ in range(2))
        mk, mv = (torch.randn((b, s, d), generator=gen, device=dev).to(bf)
                  for _ in range(2))
        pos = torch.arange(t, device=dev)
        tmask = torch.where((pos[None, :] <= pos[:, None])[None]
                            .expand(b, t, t), 0.0, -1e9).contiguous()
        keep = torch.ones((b, 1, s), dtype=torch.bool, device=dev)
        keep[1, :, 150:] = False
        smask = torch.where(keep, 0.0, -1e9).contiguous()
        seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                             device=dev)
        w = {k_: v_.to(bf) for k_, v_ in _layer_weights(
            gen, dev, lto.DEC_WEIGHTS, d, f).items()}
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (x, mk, mv, tmask, smask, seeds, w)
        out, saved, grads, e_f, e_b, bargs = _tc_layer_check("dec", fargs,
                                                             g, kw)
        hold("dec_layer_fwd", fargs, kw)
        hold("dec_layer_bwd", bargs, kw)
        ws = [w[k_] for k_ in lto.DEC_WEIGHTS]
        m = b * t
        acts = {k_: saved[i].reshape(m, -1).to(bf) for k_, i in
                (("y1", 2), ("ao", 4), ("y2", 5), ("co", 7), ("y3", 8),
                 ("hd", 11))}
        g_fwd, g_bwd = _layer_gemms(acts, w, decoder=True)
        g_bwd = [(a_.to(bf), b_.to(bf)) for a_, b_ in g_bwd]
        pairs = (float((tmask >= 0).sum()) + float(
            (smask >= 0).expand(b, t, s).sum())) * heads
        proj = float(m) * (6 * d * d + 2 * d * f)
        dh = d // heads
        shape = f"B={b} T={t} S={s} d={d} d_ff={f} H={heads} bf16 ({label})"
        row("dec_layer_train_fwd_bf16", shape,
            lambda: ltk.dec_layer_fwd(*fargs, **kw),
            lambda: lto.dec_fwd_plain(*fargs[:6], *ws, **kw),
            TF_TRAIN_KERNELS, nbytes(x, mk, mv, tmask, smask, *ws, out),
            0.0, 2.0 * proj + 4.0 * pairs * dh, e_f, iters=5,
            lib=lambda: [torch.matmul(a_, b_) for a_, b_ in g_fwd],
            lib_what="its products alone, bf16 cuBLAS",
            f32_ms=f32_of("dec_layer_train_fwd", label))
        row("dec_layer_train_bwd_bf16", shape,
            lambda: ltk.dec_layer_bwd(*bargs, **kw),
            lambda: lto.dec_bwd_plain(*fargs[:6], saved[0].to(bf),
                                      saved[1].to(bf), g, *ws, **kw),
            TF_TRAIN_KERNELS,
            nbytes(x, mk, mv, tmask, smask, *ws, g, *grads),
            0.0, 4.0 * proj + 10.0 * pairs * dh, e_b, iters=5,
            lib=lambda: [torch.matmul(a_, b_) for a_, b_ in g_bwd],
            lib_what="its products alone, bf16 cuBLAS",
            f32_ms=f32_of("dec_layer_train_bwd", label))
        del out, saved, grads, acts, g_fwd, g_bwd

    # B6 / B7 at ragged shapes: held, a rerun of the backward bit for bit
    for b, t, d, f, heads in BF16_ENC_RAGGED:
        x, g, _, maskadd, seed_l, w, _ = _enc_layer_inputs(dev, gen, b, t, d,
                                                           f)
        w = {k_: v_.to(bf) for k_, v_ in w.items()}
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (x.to(bf), maskadd, seed_l, w)
        *_, e_f, e_b, bargs = _tc_layer_check("enc", fargs, g.to(bf), kw)
        hold("enc_layer_fwd", fargs, kw)
        hold("enc_layer_bwd", bargs, kw)
        log(f"kernel enc_layer_train bf16 [B={b} T={t} d={d} d_ff={f} "
            f"H={heads}] (ragged): forward {e_f:.3g}, backward {e_b:.3g} of "
            f"each tensor's scale (held at {BF16_TOL}); the backward twice "
            "bit for bit; on the tensor cores")
    for b, t, s_, d, f, heads in BF16_DEC_RAGGED:
        x, g = (torch.randn((b, t, d), generator=gen, device=dev).to(bf)
                for _ in range(2))
        mk, mv = (torch.randn((b, s_, d), generator=gen, device=dev).to(bf)
                  for _ in range(2))
        pos = torch.arange(t, device=dev)
        tmask = torch.where((pos[None, :] <= pos[:, None])[None]
                            .expand(b, t, t), 0.0, -1e9).contiguous()
        smask = torch.zeros((b, 1, s_), device=dev)
        smask[0, :, s_ // 2:] = -1e9
        seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                             device=dev)
        w = {k_: v_.to(bf) for k_, v_ in _layer_weights(
            gen, dev, lto.DEC_WEIGHTS, d, f).items()}
        kw = dict(n_heads=heads, rate=TRAIN_RATE)
        fargs = (x, mk, mv, tmask, smask, seeds, w)
        *_, e_f, e_b, bargs = _tc_layer_check("dec", fargs, g, kw)
        hold("dec_layer_fwd", fargs, kw)
        hold("dec_layer_bwd", bargs, kw)
        log(f"kernel dec_layer_train bf16 [B={b} T={t} S={s_} d={d} "
            f"d_ff={f} H={heads}] (ragged): forward {e_f:.3g}, backward "
            f"{e_b:.3g} of each tensor's scale (held at {BF16_TOL}); the "
            "backward twice bit for bit; on the tensor cores")

    # B4: the stack and one layer, in each mixture; C5 at draws of its own
    for c in _b4_bf16_cases(dev, gen, BF16_TFD_MIXES):
        kw = c["kw"]
        e = _tf_check(c["kind"], c["args"], kw, True)
        hold(c["kind"], c["args"], kw)
        _tfd_tc_check(c)
        kk, pp = list(_clone(c["args"])), list(_clone(c["args"]))
        fn = getattr(tdk, c["kind"])
        pfn = getattr(tdo, c["kind"] + "_plain")
        row(c["name"], c["label"], lambda f_=fn, k_=kk: f_(*k_, **kw),
            lambda f_=pfn, p_=pp: f_(*p_, **kw), TF_TFD_KERNELS, c["bytes"],
            0.0 if c["all_bf"] else c["flops"],
            c["flops"] if c["all_bf"] else 0.0, e, lib=c["lib"],
            lib_what=("its products alone, bf16 cuBLAS" if c["all_bf"]
                      else "none"),
            f32_ms=f32_of(c["name"][:-5], c["shape_label"]))
        rows[c["name"]][-1].update(route=c["route"],
                                   tensor_cores=c["all_bf"])
    c5 = _c5_check(dev)

    # B11 with a bf16 store
    for label, b, h, w_, ho in BF16_IMG_CASES:
        host, imgs = _img_input(dev, b, h, w_)
        kw = dict(h_out=ho, w_out=ho, out_dtype=bf)
        e = _tf_check("resize_normalize", (imgs,), kw, True)
        hold("resize_normalize", (imgs,), kw)
        out = imk.resize_normalize(imgs, **kw)
        if h == ho and w_ == ho:
            from unpaired_image_captioning_tpu_torch.data.dataloader import (
                to_bfloat16)

            want = to_bfloat16(imo.preprocess_images(host))
            if not torch.equal(out.cpu().view(torch.int16),
                               want.view(torch.int16)):
                raise AssertionError(f"resize_normalize bf16 {label}: not "
                                     "bit for bit the host's rounding")
            log(f"kernel resize_normalize bf16 [{label}]: bit for bit "
                "to_bfloat16(preprocess_images) on the host")
        xin = imgs.permute(0, 3, 1, 2).float()
        row("image_front_end_bf16", f"[{b}, {h}, {w_}, 3] -> {ho}^2 bf16 "
            f"({label})", lambda: imk.resize_normalize(imgs, **kw),
            lambda: imo.resize_normalize_plain(imgs, **kw), "front_end_kernel",
            nbytes(imgs, out), 6.0 * out.numel(), 0.0, e,
            lib=lambda: F.interpolate(xin, size=(ho, ho), mode="bilinear",
                                      align_corners=False),
            lib_what="F.interpolate (f32 NCHW, the resize alone)",
            f32_ms=f32_of("image_front_end", label))
    torch.cuda.synchronize()

    csrc = "unpaired_image_captioning_tpu_torch/csrc/"
    src = {"ln_train": ("ln_train.cu", "ln_train.py:52", "ln_train.py:60"),
           "mha_train": ("mha_train.cu", "mha_train.py:111",
                         "mha_train.py:125"),
           "enc_layer_train": ("layer_train.cu", "layer_train.py:131",
                               "layer_train.py:163"),
           "dec_layer_train": ("layer_train.cu", "layer_train.py:444",
                               "layer_train.py:476")}
    rec = {}
    for base, (cu, fwd_line, bwd_line) in src.items():
        for key, line in (("fwd", fwd_line), ("bwd", bwd_line)):
            name = f"{base}_{key}_bf16"
            rec[name] = _bf16_record(name, csrc + cu, line, rows[name])
    for name, cu, line in (
            ("transformer_decode_stack", "transformer_decode.cu",
             "transformer_decode.py:275"),
            ("transformer_decode_layer", "transformer_decode.cu",
             "transformer_decode.py:229"),
            ("image_front_end", "image_front_end.cu", "image.py:46")):
        rec[name + "_bf16"] = _bf16_record(name + "_bf16", csrc + cu, line,
                                           rows[name + "_bf16"])
    rec["transformer_decode_stack_bf16"]["c5"] = c5
    return rec, held


BF16_STEPS = 4        # joint XE steps on one batch: the loss must fall
BF16_AGREE = 2        # images of the card-vs-cpu step; 4 of the pivot


class _recording_bf16:
    """While open, every call to the wrappers of B1, B9a-c and B10 adds
    its (shape, dtype mixture) to `seen[name]`, keyed as
    `phase_bf16_kernels` holds them (all-f32 calls too: each is held), and
    `calls[(name, key)]` counts the calls on the card."""

    def __init__(self, seen: dict):
        from unpaired_image_captioning_tpu_torch.kernels import (
            additive_attention as aak)
        from unpaired_image_captioning_tpu_torch.kernels import (
            lstm_block as lb)
        from unpaired_image_captioning_tpu_torch.kernels import (
            lstm_cell as lk)

        def mix(*ts):
            return tuple(_mix_name([t.dtype]) for t in ts)

        def cell(a, kw):
            w, _, x, h = a[:4]
            return (x.shape[0], x.shape[1], h.shape[1], a[5], mix(x, w, h))

        def att(a, kw):
            p_att, q, alpha, mask, emb, beams = a
            k = q.shape[1] if beams else 1
            return ("additive_attention_beams" if beams
                    else "additive_attention",
                    (p_att.shape[0], k, p_att.shape[1], p_att.shape[2],
                     emb.shape[2], mix(p_att, q, alpha, mask, emb)))

        def step(a, kw):
            b, n, a_ = a[0].shape
            return (b, n, a_, a[1].shape[2], a[5].shape[1],
                    mix(a[0], a[1], a[2], a[3], a[4], a[5], a[7], a[9],
                        a[13]))

        def chain(a, kw):
            t, b, gh = a[0].shape
            h = a[1].shape[-1] if len(a) == 4 else a[2].shape[-1]
            carry, w = (a[1], a[3]) if len(a) == 4 else (a[2], a[5])
            return (t, b, h, gh // h, mix(carry, w))

        self._sites = [(lk, "_forward", lambda a, kw: ("lstm_cell",
                                                       cell(a, kw))),
                       (aak, "_attention_fwd", att),
                       (aak, "fused_att_lstm_att",
                        lambda a, kw: ("att_lstm_att", step(a, kw))),
                       (lb, "chain_fwd",
                        lambda a, kw: ("lstm_chain", chain(a, kw))),
                       (lb, "chain_bwd",
                        lambda a, kw: ("lstm_chain", chain(a, kw)))]
        self._seen = seen
        self.calls = {}

    def __enter__(self):
        self._saved = []
        for mod, attr, key in self._sites:
            fn = getattr(mod, attr)

            def call(*a, _fn=fn, _key=key, **kw):
                name, k = _key(a, kw)
                self._seen.setdefault(name, set()).add(k)
                if a[0].device.type == "cuda":
                    self.calls[(name, k)] = self.calls.get((name, k), 0) + 1
                return _fn(*a, **kw)

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, call)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def _hold_bf16(dev, seen: dict, held: dict) -> dict:
    """Every (shape, mixture) `_recording_bf16` recorded and no check of
    `phase_bf16_kernels` (or, all f32, of the f32 phases) holds: the kernel
    against its plain version there, on seeded inputs, at BF16_TOL (an
    f32 one at its f32 tolerance). Returns {kernel: keys held here}."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.ops import attention as ao
    from unpaired_image_captioning_tpu_torch.ops import lstm_block as lo

    gen = torch.Generator(device=dev).manual_seed(31)
    done = {}

    def close(label, got, want, f32):
        if f32:
            _check_each(label, ["out"] * len(got), got, want, LSTM_TOL)
        else:
            _bf16_close(label, got, want)

    for key in sorted(seen.get("lstm_cell", ()), key=str):
        if key in held["lstm_cell"]:
            continue
        b, d, h, maxout, mix = key
        g = 5 if maxout else 4
        tx, tw, th = (_dt(m) for m in mix)
        w = ((torch.rand((d + h, g * h), generator=gen, device=dev) * 2 - 1)
             / h ** 0.5).to(tw)
        bias = ((torch.rand((g * h,), generator=gen, device=dev) * 2 - 1)
                / h ** 0.5).to(tw)
        x = torch.randn((b, d), generator=gen, device=dev).to(tx)
        h0, c0 = (torch.randn((b, h), generator=gen, device=dev).to(th)
                  for _ in range(2))
        with torch.no_grad():
            close(f"lstm_cell {key}", lk.lstm_cell(w, bias, x, h0, c0,
                                                    maxout=maxout),
                  lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout),
                  mix == ("f32",) * 3)
        done.setdefault("lstm_cell", []).append(key)
    for name in ("additive_attention", "additive_attention_beams"):
        for key in sorted(seen.get(name, ()), key=str):
            if key in held[name]:
                continue
            b, k, n, a, d, mix = key
            base = _att_inputs(dev, gen, None if name == "additive_attention"
                               else k, (b, n, a, d))
            args = [t.to(_dt(m)) for t, m in zip(base, mix)]
            fn = (aak.additive_attention if name == "additive_attention"
                  else aak.additive_attention_beams)
            plain = (ao.reference_attention if name == "additive_attention"
                     else ao.reference_attention_beams)
            with torch.no_grad():
                close(f"{name} {key}", [fn(*args)], [plain(*args)],
                      mix == ("f32",) * 5)
            done.setdefault(name, []).append(key)
    for key in sorted(seen.get("att_lstm_att", ()), key=str):
        if key in held["att_lstm_att"]:
            continue
        b, n, a, d, h, mix = key
        step = _step_args(dev, gen, (b, n, a, d, h))
        groups = ((0,), (1,), (2,), (3,), (4,), (5, 6), (7, 8),
                  (9, 10, 11, 12), (13, 14))
        for idx, m in zip(groups, mix):
            for i in idx:
                step[i] = step[i].to(_dt(m))
        with torch.no_grad():
            close(f"att_lstm_att {key}", aak.fused_att_lstm_att(*step),
                  ao.att_lstm_att_plain(*step), mix == ("f32",) * 9)
        done.setdefault("att_lstm_att", []).append(key)
    for key in sorted(seen.get("lstm_chain", ()), key=str):
        if key in held["lstm_chain"]:
            continue
        t, b, h, g, (tc, tw) = key
        maxout = g == 5
        xc = torch.randn((t, b, g * h), generator=gen, device=dev)
        w = (torch.randn((h, g * h), generator=gen, device=dev)
             / h ** 0.5).to(_dt(tw))
        h0, c0 = (torch.randn((b, h), generator=gen, device=dev).to(_dt(tc))
                  for _ in range(2))
        dhs, dcs = (torch.randn((t, b, h), generator=gen, device=dev).to(
            _dt(tc)) for _ in range(2))
        f32 = (tc, tw) == ("f32", "f32")
        hs, cs, gates = lb.chain_fwd(xc, h0, c0, w, maxout=maxout)
        close(f"lstm_chain forward {key}", [hs, cs, gates],
              list(lo.chain_fwd_plain(xc, h0, c0, w, maxout=maxout)), f32)
        close(f"lstm_chain backward {key}",
              list(lb.chain_bwd(gates, cs, c0, dhs, dcs, w, maxout=maxout)),
              list(lo.chain_bwd_plain(gates, cs, c0, dhs, dcs, w,
                                      maxout=maxout)), f32)
        done.setdefault("lstm_chain", []).append(key)
    torch.cuda.synchronize()
    return done


def _grads_agree(label: str, got: dict, want: dict) -> float:
    """Each gradient card vs cpu: max|diff| / max(1, max|cpu|) <=
    BF16_TOL; returns the largest."""
    worst = 0.0
    for k, w in want.items():
        e = ((got[k].cpu() - w).abs().max().item()
             / max(1.0, w.abs().max().item()))
        if not e <= BF16_TOL:
            raise AssertionError(f"{label}: gradient {k} card vs cpu "
                                 f"{e:.3g} > {BF16_TOL}")
        worst = max(worst, e)
    return worst


def _cast_step_grads(trainer, batch, sc_flag=False):
    """The cast route's loss and gradients of one step (the trainer's
    forward and backward under its bf16 copies, no update)."""
    metrics = {}
    with trainer._compute_params():
        total, _ = trainer._losses(batch, sc_flag, True,
                                   trainer.nmt_model is not None, 0.0,
                                   metrics)
        total.backward()
    grads = {f"{key}.{n}": p.grad.detach().clone()
             for key, m in trainer._models() if m is not None
             for n, p in m.named_parameters() if p.grad is not None}
    for _, m in trainer._models():
        if m is not None:
            m.zero_grad(set_to_none=True)
    return float(total.detach()), metrics, grads


BF16_TNMT_STEPS = 2   # transformer-NMT XE steps of the bf16 path


def _bf16_transformer_path(dev, ttr, tsc, tnt, tcap, tnmt, tbatch, nbatch,
                           labels, zh_vocab, tgt_itos, cap2nmt, fc, att,
                           host_imgs, walls: dict) -> None:
    """The bf16 transformer path of `phase_bf16_path` (see its doc), run
    while its counters and recorders are open."""
    import torch

    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)
    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.models import transformer as tm
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.ops.image import (
        preprocess_images)
    from unpaired_image_captioning_tpu_torch.serve import PivotService

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the captioner's XE: the default route, then per sublayer and with
    # whole decoder layers
    losses, step_ms = [], []
    old = _route_flags(True, False)
    try:
        for _ in range(BF16_STEPS):
            out, ms = timed(lambda: ttr.train(tbatch))
            losses.append(out["total_loss"])
            step_ms.append(ms)
        _route_flags(False, False)
        out_sub, ms_sub = timed(lambda: ttr.train(tbatch))
        _route_flags(True, True)
        out_dec, ms_dec = timed(lambda: ttr.train(tbatch))
    finally:
        _route_flags(*old)
    walls["transformer XE steps 2- (B6)"] = statistics.mean(step_ms[1:])
    walls["transformer XE per sublayer"] = ms_sub
    walls["transformer XE B6 + B7"] = ms_dec
    more = [out_sub["total_loss"], out_dec["total_loss"]]
    if not (all(np.isfinite(losses + more)) and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 transformer XE: losses {losses} (then "
                             f"{more}) not finite and falling")
    log(f"bf16 transformer XE (batch {BENCH_BATCH}, bf16 copies of the f32 "
        f"masters): default route losses " + ", ".join(
            f"{v:.5f}" for v in losses) + f", walls (ms) " + ", ".join(
            f"{v:.1f}" for v in step_ms) + f"; per sublayer {more[0]:.5f} "
        f"({ms_sub:.1f} ms); B6 + B7 {more[1]:.5f} ({ms_dec:.1f} ms)")

    # one SCST step: the sample and the greedy baseline through B4
    sc_batch = dict(tbatch, **scst_gts(labels, BENCH_BATCH))
    out_rl, ms_rl = timed(lambda: tsc.train(sc_batch, sc_flag=True))
    walls["transformer SCST step"] = ms_rl
    if not (np.isfinite(out_rl["total_loss"])
            and np.isfinite(out_rl["avg_reward"])):
        raise AssertionError(f"bf16 transformer SCST step: {out_rl}")
    log(f"bf16 transformer SCST step (batch {BENCH_BATCH}): loss "
        f"{out_rl['i2t_loss']:.6f}, avg_reward {out_rl['avg_reward']:.5f}, "
        f"wall {ms_rl:.1f} ms")

    # the transformer NMT's XE
    n_losses, n_ms = [], []
    for _ in range(BF16_TNMT_STEPS):
        out, ms = timed(lambda: tnt.train(nbatch))
        n_losses.append(out["total_loss"])
        n_ms.append(ms)
    walls["transformer NMT XE step"] = n_ms[-1]
    if not all(np.isfinite(n_losses)):
        raise AssertionError(f"bf16 transformer NMT XE: {n_losses}")
    log(f"bf16 transformer NMT XE (batch {BENCH_BATCH}): losses " + ", ".join(
        f"{v:.5f}" for v in n_losses) + ", walls (ms) " + ", ".join(
        f"{v:.1f}" for v in n_ms))

    # the transformer pivot through PivotService: the card rounds the
    # features, so B4 runs f32 weights over bf16 memory and caches
    svc = PivotService(tcap, tnmt, zh_vocab, tgt_itos, cap2nmt,
                       cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                       nmt_max_len=NMT_MAX_LEN, max_batch=MAX_BATCH)
    try:
        answers = [None] * N_REQUESTS

        def one(i):
            answers[i] = svc.pivot(fc[i], att[i], timeout=600)

        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(N_REQUESTS)]
        t0 = time.perf_counter()
        for w_ in workers:
            w_.start()
        for w_ in workers:
            w_.join(600)
        walls[f"transformer pivot, {N_REQUESTS} requests"] = (
            time.perf_counter() - t0) * 1e3
    finally:
        svc.close()
    if None in answers or not all(a["zh"] for a in answers):
        raise AssertionError("bf16 transformer PivotService: a request "
                             "unanswered or an empty caption")
    # a bf16-feature greedy decode one layer a call (B4's layer kernel)
    bfe = Features(fc_feats=to_bfloat16(fc[:BENCH_BATCH]).to(dev),
                   att_feats=to_bfloat16(att[:BENCH_BATCH]).to(dev),
                   att_masks=torch.ones((BENCH_BATCH, N_SLOTS), device=dev))
    old_stack = tm.STACK_KERNEL
    tm.STACK_KERNEL = False
    try:
        with torch.inference_mode():
            seq, _ = tcap.sample(bfe, greedy=True)
    finally:
        tm.STACK_KERNEL = old_stack
    log(f"bf16 transformer pivot: {N_REQUESTS} requests in "
        f"{walls[f'transformer pivot, {N_REQUESTS} requests']:.1f} ms; a "
        f"greedy decode of {BENCH_BATCH} rounded images one layer a call, "
        f"{seq.shape[1]} steps")

    # the raw-image loader's batch stored bf16 (B11)
    imgs = torch.from_numpy(host_imgs).to(dev)
    got = imk.resize_normalize(imgs, h_out=448, w_out=448,
                               out_dtype=torch.bfloat16)
    want = to_bfloat16(preprocess_images(host_imgs))
    if not torch.equal(got.cpu().view(torch.int16), want.view(torch.int16)):
        raise AssertionError("B11 bf16 store: not bit for bit the host's "
                             "rounding at the loader's identity size")
    log(f"bf16 B11 store: {tuple(got.shape)} bf16 at the loader's identity "
        "size, bit for bit to_bfloat16(preprocess_images)")
    torch.cuda.synchronize()


def phase_bf16_path(dev, held: dict, tf_held: dict) -> dict:
    """The bf16 compute dtype on the card (ROADMAP A15), through the entry
    points a user calls, with the launch counts of the bf16 entries set to
    0 just before and read just after:

    - `Trainer.train` of the joint denseatt + BiLSTM NMT step with
      `dtype="bfloat16"` at batch 50 (bf16 copies of the f32 masters),
      BF16_STEPS steps on one batch, the loss falling; one more with
      TRAIN_KERNEL (B9a);
    - one SCST step (`sc_flag=True`) of the denseatt captioner;
    - the LSTM pivot through `PivotService` (the card rounds the features
      to bf16), 40 requests; decodes of bf16 features with SINGLE_KERNEL,
      STEP_FUSION and BEAMS_KERNEL (B9a, B9c, B9b);
    - the lstm0 fragment through `blocked_lstm_chain` with a bf16 carry
      and weights (B10);
    - the transformer captioner's XE with `dtype="bfloat16"` at batch 50:
      BF16_STEPS steps on the default route (B6) with the loss falling,
      one per sublayer (B5, B8) and one with whole decoder layers (B6 +
      B7); one transformer SCST step (the sample and greedy decodes
      through B4, every operand bf16); BF16_TNMT_STEPS transformer-NMT XE
      steps; the transformer pivot through `PivotService` (the card
      rounds the features: B4 over bf16 memory and caches), 40 requests,
      and a bf16-feature greedy decode one layer a call (B4's layer
      kernel); the raw-image loader's batch stored bf16 (B11);
    - card vs cpu at BF16_TOL: the joint step's loss and gradients on
      BF16_AGREE images (the cpu runs the same cast route's plain
      versions on the same rounded features and bf16 copies), the
      transformer captioner's XE step the same way, and the pivot's
      teacher-forced logprobs on 4 images of rounded features.

    Every (shape, mixture) given a kernel is held against the plain
    version (`_hold_bf16`, `_hold_tf`: the transformer kernels on the
    very inputs of the first call of each). Returns the bf16 launches by
    kernel record."""
    import copy

    import torch

    from unpaired_image_captioning_tpu_torch.config import Config
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)
    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.models.base import Features
    from unpaired_image_captioning_tpu_torch.ops.cider import build_df_table
    from unpaired_image_captioning_tpu_torch.pivot import (
        captions_to_nmt_batch, pivot_translate)
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)
    from unpaired_image_captioning_tpu_torch.serve import PivotService
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    from unpaired_image_captioning_tpu_torch.kernels import image as imk
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models import transformer as tm

    t_phase = time.perf_counter()
    counters = {"lstm_cell_bf16": (lk, "bf16_launches"),
                "additive_attention_bf16": (aak, "bf16_launches"),
                "additive_attention_beams_bf16": (aak,
                                                  "beams_bf16_launches"),
                "att_lstm_att_bf16": (aak, "step_bf16_launches"),
                "lstm_chain_fwd_bf16": (lb, "fwd_bf16_launches"),
                "lstm_chain_bwd_bf16": (lb, "bwd_bf16_launches"),
                "ln_train_fwd_bf16": (lnk, "bf16_fwd_launches"),
                "ln_train_bwd_bf16": (lnk, "bf16_bwd_launches"),
                "mha_train_fwd_bf16": (mhk, "bf16_fwd_launches"),
                "mha_train_bwd_bf16": (mhk, "bf16_bwd_launches"),
                "enc_layer_train_fwd_bf16": (ltk, "bf16_enc_fwd_launches"),
                "enc_layer_train_bwd_bf16": (ltk, "bf16_enc_bwd_launches"),
                "dec_layer_train_fwd_bf16": (ltk, "bf16_dec_fwd_launches"),
                "dec_layer_train_bwd_bf16": (ltk, "bf16_dec_bwd_launches"),
                "transformer_decode_stack_bf16": (tdk,
                                                  "bf16_stack_launches"),
                "transformer_decode_layer_bf16": (tdk,
                                                  "bf16_layer_launches"),
                "image_front_end_bf16": (imk, "bf16_launches")}
    seen, walls = {}, {}
    tf_seen, tf_args = {}, {}
    cfg = dict(JOINT_TRAIN, dtype="bfloat16")
    rs = np.random.RandomState(40)
    batch = make_joint_batch(rs, BENCH_BATCH)
    trainer = Trainer(Config(**cfg), device=dev, **joint_trainer_kw(cfg))
    if not trainer.cast:
        raise AssertionError("dtype='bfloat16' on the card: no cast route")
    labels, start, end = make_scst_corpus(np.random.RandomState(0))
    df, n_img = compute_df(labels, start, end)
    table = build_df_table(df, float(n_img), dev)
    scst = Trainer(Config(**dict(DTRAIN, dtype="bfloat16")), device=dev,
                   df_table=table)
    cap, nmt, zh_vocab, tgt_itos, cap2nmt = build_models(dev)
    fc, att = make_features(np.random.RandomState(41),
                            max(N_REQUESTS, BENCH_BATCH))
    # the transformers: the captioner's XE and SCST trainers, the NMT's,
    # and the full-width pivot
    tcfg = dict(TRAIN, dtype="bfloat16")
    ttr = Trainer(Config(**tcfg), device=dev)
    tsc = Trainer(Config(**tcfg), device=dev, df_table=table)
    tnt = Trainer(Config(**dict(TNMT_TRAIN, dtype="bfloat16")), device=dev)
    tcap, tnmt = build_transformer_models(dev)
    if not (ttr.cast and tsc.cast and tnt.cast):
        raise AssertionError("dtype='bfloat16' on the card: a transformer "
                             "Trainer without the cast route")
    tbatch = make_train_batch(np.random.RandomState(43), BENCH_BATCH)
    nbatch = make_nmt_batch(np.random.RandomState(44), BENCH_BATCH)
    host_imgs = np.random.RandomState(45).randint(
        0, 256, (16, 448, 448, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    # the tensor-core counters: every all-bf16 B1 launch, every bf16 B6 /
    # B7 launch and every bf16 B5 call of the path's head width (alone and
    # inside B6 / B7) runs a tensor-core instance
    tc_counters = {"lstm_cell_bf16": (lk, "tc_launches"),
                   "mha_train_fwd_bf16": (mhk, "tc_fwd_launches"),
                   "mha_train_bwd_bf16": (mhk, "tc_bwd_launches"),
                   "transformer_decode_stack_bf16": (tdk,
                                                     "tc_stack_launches"),
                   "transformer_decode_layer_bf16": (tdk,
                                                     "tc_layer_launches")}
    for kind in ("enc", "dec"):
        for x_ in ("fwd", "bwd"):
            tc_counters[f"{kind}_layer_train_{x_}_bf16"] = (
                ltk, f"tc_{kind}_{x_}_launches")
    tc_in_layers = {"mha_train_fwd_bf16": (ltk, "tc_attn_fwd_launches"),
                    "mha_train_bwd_bf16": (ltk, "tc_attn_bwd_launches")}
    for mod, attr in (list(counters.values()) + list(tc_counters.values())
                      + list(tc_in_layers.values())):
        setattr(mod, attr, 0)
    cells = _recording_bf16(seen)
    tf_rec = _recording_tf(tf_seen, tf_args, tf_held)
    with cells, tf_rec:
        # the joint XE step
        losses, step_ms = [], []
        for _ in range(BF16_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trainer.train(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(out["total_loss"])
        old = _train_kernel_flag(True)
        try:
            out_k = trainer.train(batch)
        finally:
            _train_kernel_flag(*old)
        walls["joint XE steps 2-"] = statistics.mean(step_ms[1:])
        if not (all(np.isfinite(losses + [out_k["total_loss"]]))
                and losses[-1] < losses[0]):
            raise AssertionError(f"bf16 joint XE: losses {losses} not "
                                 "finite and falling")
        log(f"bf16 joint XE (denseatt + BiLSTM NMT, batch {BENCH_BATCH}, "
            f"bf16 copies of the f32 masters): losses " + ", ".join(
                f"{v:.5f}" for v in losses) + f", then with TRAIN_KERNEL "
            f"{out_k['total_loss']:.5f}; step walls (ms) " + ", ".join(
                f"{v:.1f}" for v in step_ms) + "; parameters "
            + ", ".join(sorted({str(p.dtype) for p in
                                trainer.i2t_model.parameters()})))
        # one SCST step
        sc_batch = dict(make_train_batch(rs, BENCH_BATCH),
                        **scst_gts(labels, BENCH_BATCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_rl = scst.train(sc_batch, sc_flag=True)
        torch.cuda.synchronize()
        walls["SCST step"] = (time.perf_counter() - t0) * 1e3
        if not (np.isfinite(out_rl["total_loss"])
                and np.isfinite(out_rl["avg_reward"])):
            raise AssertionError(f"bf16 SCST step: {out_rl}")
        log(f"bf16 SCST step (denseatt, batch {BENCH_BATCH}): loss "
            f"{out_rl['i2t_loss']:.6f}, avg_reward "
            f"{out_rl['avg_reward']:.5f}, wall {walls['SCST step']:.1f} ms")
        # the LSTM pivot through PivotService: the card rounds the features
        svc = PivotService(cap, nmt, zh_vocab, tgt_itos, cap2nmt,
                           cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                           nmt_max_len=NMT_MAX_LEN, max_batch=MAX_BATCH)
        try:
            answers = [None] * N_REQUESTS

            def one(i):
                answers[i] = svc.pivot(fc[i], att[i], timeout=600)

            workers = [threading.Thread(target=one, args=(i,))
                       for i in range(N_REQUESTS)]
            t0 = time.perf_counter()
            for w_ in workers:
                w_.start()
            for w_ in workers:
                w_.join(600)
            walls[f"pivot, {N_REQUESTS} requests"] = (
                time.perf_counter() - t0) * 1e3
        finally:
            svc.close()
        if None in answers or not all(a["zh"] and a["en"] for a in answers):
            raise AssertionError("bf16 PivotService: a request unanswered "
                                 "or an empty caption")
        # decodes of bf16 features on the kernel routes of the attention
        bfe = Features(fc_feats=to_bfloat16(fc[:BENCH_BATCH]).to(dev),
                       att_feats=to_bfloat16(att[:BENCH_BATCH]).to(dev),
                       att_masks=torch.ones((BENCH_BATCH, N_SLOTS),
                                            device=dev))
        c2n = torch.as_tensor(cap2nmt, device=dev)
        with torch.inference_mode():
            for flags in ({"SINGLE_KERNEL": True}, {"STEP_FUSION": True}):
                old = _att_flags(**flags)
                try:
                    cap.sample(bfe, greedy=True)
                finally:
                    _att_flags(**old)
            old = _att_flags(BEAMS_KERNEL=True)
            try:
                pivot_translate(cap, nmt, bfe, c2n, cap_beam=CAP_BEAM,
                                nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
            finally:
                _att_flags(**old)
        # the lstm0 fragment with a bf16 carry and weights
        w, bias, x, h0, c0, ch, cc = _chain_inputs(
            dev, torch.Generator(device=dev).manual_seed(2), 5)
        b_, t_, d_, h_ = CHAIN_SHAPE
        lw = w.to(torch.bfloat16).requires_grad_()
        lh0, lc0 = (v.to(torch.bfloat16).requires_grad_() for v in (h0, c0))
        xc = (x.reshape(t_ * b_, d_) @ lw[:d_].float()
              + bias).reshape(t_, b_, -1)
        hs, cs = lb.blocked_lstm_chain(xc, lh0, lc0, lw[d_:], maxout=True)
        ((hs.float() * ch).sum() + (cs.float() * cc).sum()).backward()
        if not all(torch.isfinite(v.grad.float()).all()
                   for v in (lw, lh0, lc0)):
            raise AssertionError("bf16 lstm0 fragment: a non-finite gradient")
        torch.cuda.synchronize()
        _bf16_transformer_path(dev, ttr, tsc, tnt, tcap, tnmt, tbatch,
                               nbatch, labels, zh_vocab, tgt_itos, cap2nmt,
                               fc, att, host_imgs, walls)
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    tc_counts = {name: getattr(mod, attr)
                 for name, (mod, attr) in tc_counters.items()}
    log("bf16 path launches: " + ", ".join(f"{k} {v}"
                                          for k, v in counts.items()))
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"the bf16 path never launched {name}")
    all_bf = sum(n for (name, k), n in cells.calls.items()
                 if name == "lstm_cell" and k[-1] == ("bf16",) * 3)
    want = dict((k, counts[k]) for k in tc_counters)
    want["lstm_cell_bf16"] = all_bf
    # B5: every bf16 call the path made is of a tensor-core head width, so
    # every one of them, and every attention inside the bf16 layer calls
    # (one an encoder layer, two a decoder layer), is on the tensor cores
    widths = {(kind, key[0][-1] // key[3]) for kind in ("mha_train_fwd",
                                                        "mha_train_bwd")
              for key in tf_seen.get(kind, ()) if key[-1] == ("bf16",)}
    # the layers' keys (_tf_key): (x's shape, d_ff, heads, ...) and (x's
    # shape, S, d_ff, heads, ...)
    widths |= {(kind, key[0][-1] // key[2 if kind[0] == "e" else 3])
               for kind in ("enc_layer_fwd", "enc_layer_bwd",
                            "dec_layer_fwd", "dec_layer_bwd")
               for key in tf_seen.get(kind, ()) if key[-1][0] == "bf16"}
    off = sorted(w for w in widths
                 if not mhk.tensor_core(torch.bfloat16, w[1]))
    if off:
        raise AssertionError(f"bf16 path: B5 calls off the tensor cores' "
                             f"head widths {off}")
    # B4: every call of a bf16 mixture on the fast attentions, and every
    # all-bf16 call on the tensor cores, by the rule
    for name, kind in (("transformer_decode_stack_bf16",
                        "decoder_stack_step"),
                       ("transformer_decode_layer_bf16",
                        "decoder_layer_step")):
        want[name] = 0
        for (kind_, key), n in tf_rec.calls.items():
            if kind_ != kind or key[-1] == ("f32",) * 4:
                continue
            rows_, (bsz, slots, d_), (n_t, _) = (key[0], key[1][-3:],
                                                  key[2][-2:])
            fl = sum(f for f, m in zip((1, 2, 4, 8), key[-1]) if m == "bf16")
            rt = tdk.route(fl, d_, key[3], key[4], n_t, slots)
            if rt & (tdk.ROUTE_SELF | tdk.ROUTE_CROSS) != (
                    tdk.ROUTE_SELF | tdk.ROUTE_CROSS):
                raise AssertionError(f"bf16 path: {kind} {key} off the fast "
                                     f"attentions (route {rt})")
            if key[-1] == ("bf16",) * 4:
                if not rt & tdk.ROUTE_TC:
                    raise AssertionError(f"bf16 path: {kind} {key} all bf16 "
                                         "off the tensor cores")
                want[name] += n
    in_layers = {name: getattr(mod, attr)
                 for name, (mod, attr) in tc_in_layers.items()}
    want_in = {f"mha_train_{x_}_bf16": counts[f"enc_layer_train_{x_}_bf16"]
               + 2 * counts[f"dec_layer_train_{x_}_bf16"]
               for x_ in ("fwd", "bwd")}
    log("bf16 path tensor-core launches: " + ", ".join(
        f"{k} {tc_counts[k]} of {want[k]}" for k in tc_counters)
        + "; B5 inside the bf16 layer calls: " + ", ".join(
            f"{k} {in_layers[k]} of {want_in[k]}" for k in tc_in_layers)
        + f"; B1's mixed launches on the FMA core "
        f"{counts['lstm_cell_bf16'] - tc_counts['lstm_cell_bf16']}")
    if tc_counts != want or not all_bf or in_layers != want_in:
        raise AssertionError(f"bf16 path: tensor-core launches {tc_counts}, "
                             f"expected {want} (all-bf16 cells, bf16 layer "
                             f"and attention calls); B5 inside the layers "
                             f"{in_layers}, expected {want_in}")
    for name, n in in_layers.items():
        tc_counts[name + " in layers"] = n

    # card vs cpu: the joint step's loss and gradients on two images
    cfg_a = dict(cfg, batch_size=BF16_AGREE, dropout=0.0, drop_prob_lm=0.0)
    batch_a = make_joint_batch(np.random.RandomState(42), BF16_AGREE)
    kw = joint_trainer_kw(cfg_a)
    res = {}
    with _recording_bf16(seen):
        for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
            tr = Trainer(Config(**cfg_a), device=d, **kw)
            tr.cast = True      # the cpu runs the cast route's plain versions
            res[name] = _cast_step_grads(tr, batch_a)
            del tr
    (lg, mg, gg), (lc, mc, gc) = res["gpu"], res["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    g_err = _grads_agree("bf16 joint step", gg, gc)
    if not loss_err <= BF16_TOL:
        raise AssertionError(f"bf16 joint step: loss card {lg} vs cpu {lc}")
    log(f"bf16 agreement, joint step on {BF16_AGREE} images, card vs cpu "
        f"(bf16 copies, rounded features, dropout 0): loss {lg:.6f} vs "
        f"{lc:.6f} (relative {loss_err:.3g}); {len(gc)} gradients, max|diff|"
        f" / max(1, max|cpu|) {g_err:.3g} (tol {BF16_TOL})")

    # card vs cpu: the pivot on 4 images of rounded features
    n = 4
    cpu = torch.device("cpu")
    cap_c, nmt_c = copy.deepcopy(cap).to(cpu), copy.deepcopy(nmt).to(cpu)
    out = {}
    with torch.inference_mode(), _recording_bf16(seen):
        for name, d, cm, nm in (("gpu", dev, cap, nmt),
                                ("cpu", cpu, cap_c, nmt_c)):
            f = Features(fc_feats=to_bfloat16(fc[:n]).to(d),
                         att_feats=to_bfloat16(att[:n]).to(d),
                         att_masks=torch.ones((n, N_SLOTS), device=d))
            zh, en, _ = pivot_translate(cm, nm, f,
                                        torch.as_tensor(cap2nmt, device=d),
                                        cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                                        nmt_max_len=NMT_MAX_LEN)
            out[name] = (f, zh.cpu(), en.cpu())
        zh, en = out["cpu"][1], out["cpu"][2]
        seq = torch.cat([torch.zeros((n, 1), dtype=torch.long), zh], 1)
        tgt = torch.cat([torch.full((n, 1), NMT_BOS, dtype=torch.long), en],
                        1)
        lps = {}
        for name, d, cm, nm in (("gpu", dev, cap, nmt),
                                ("cpu", cpu, cap_c, nmt_c)):
            src, lengths = captions_to_nmt_batch(
                zh.to(d), torch.as_tensor(cap2nmt, device=d))
            _, nlp = _nmt_teacher_forced(nm, src, lengths, tgt.to(d))
            lps[name] = (cm.forward(out[name][0], seq.to(d)).cpu(),
                         nlp.cpu())
    errs = [((lps["gpu"][i] - lps["cpu"][i]).abs()
             / (1 + lps["cpu"][i].abs())).max().item() for i in (0, 1)]
    same = [(out["gpu"][i] == out["cpu"][i]).all(1).float().mean().item()
            for i in (1, 2)]
    log(f"bf16 agreement, LSTM pivot on {n} images of rounded features, "
        f"card vs cpu: teacher-forced |diff| / (1 + |cpu|) captioner "
        f"{errs[0]:.3g}, NMT {errs[1]:.3g} (tol {BF16_TOL}); identical "
        f"beams: zh {same[0] * 100:.0f}%, en {same[1] * 100:.0f}%")
    if not max(errs) <= BF16_TOL:
        raise AssertionError(f"bf16 pivot card vs cpu: {errs}")
    del cap_c, nmt_c

    # card vs cpu: the transformer captioner's bf16 XE step on two images
    cfg_t = dict(tcfg, batch_size=BF16_AGREE, drop_prob_lm=0.0)
    batch_t = make_train_batch(np.random.RandomState(46), BF16_AGREE)
    old_drop = tm.DROPOUT
    tm.DROPOUT = 0.0
    res = {}
    try:
        with _recording_tf(tf_seen, tf_args, tf_held):
            for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
                tr = Trainer(Config(**cfg_t), device=d)
                tr.cast = True   # the cpu runs the cast route's plain versions
                res[name] = _cast_step_grads(tr, batch_t)
                del tr
    finally:
        tm.DROPOUT = old_drop
    (lg, _, gg), (lc, _, gc) = res["gpu"], res["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    g_err = _grads_agree("bf16 transformer XE step", gg, gc)
    if not loss_err <= BF16_TOL:
        raise AssertionError(f"bf16 transformer XE step: loss card {lg} vs "
                             f"cpu {lc}")
    log(f"bf16 agreement, transformer captioner XE step on {BF16_AGREE} "
        f"images, card vs cpu (bf16 copies, rounded features, dropout 0, "
        f"default route): loss {lg:.6f} vs {lc:.6f} (relative "
        f"{loss_err:.3g}); {len(gc)} gradients, max|diff| / max(1, "
        f"max|cpu|) {g_err:.3g} (tol {BF16_TOL})")

    done = _hold_bf16(dev, seen, held)
    done.update(_hold_tf(tf_args))
    for name, keys in sorted(tf_seen.items()):
        log(f"bf16 path {name} (shape, mixture): {sorted(keys, key=str)}")
    for name, keys in sorted(seen.items()):
        log(f"bf16 path {name} (shape, mixture): {sorted(keys, key=str)}")
    log("bf16 path: held here against the plain versions: " + ", ".join(
        f"{k} {len(v)}" for k, v in done.items()))
    log("bf16 path walls (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    del trainer, scst, cap, nmt, ttr, tsc, tnt, tcap, tnmt
    torch.cuda.empty_cache()
    return counts, tc_counts


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                 "on one CUDA card (see the module's doc).")
    ap.add_argument("--times", default=None, metavar="GROUP[,GROUP]",
                    help="only build and time the kernels of these groups "
                    f"({', '.join(TIMES_GROUPS)}), with no check, and print "
                    "the readings as the last line")
    args = ap.parse_args(argv)
    groups = args.times.split(",") if args.times else []
    if set(groups) - set(TIMES_GROUPS):
        ap.error(f"--times takes groups of {TIMES_GROUPS}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    # the port must come from this checkout; fail before printing otherwise
    import unpaired_image_captioning_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from unpaired_image_captioning_tpu_torch.kernels import (
        additive_attention as aak)
    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
    from unpaired_image_captioning_tpu_torch.kernels import (
        transformer_decode as tdk)
    from unpaired_image_captioning_tpu_torch.models.resnet import (
        convert_torchvision_state_dict)

    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.perf_counter()))

    phase_device()
    phase_build()
    mark("build")
    if groups:
        readings = phase_times(dev, groups)
        print(json.dumps({"times": readings}), flush=True)
        return 0
    kernels = phase_kernels(dev)
    kernels.update(phase_chunked_topk(dev))
    kernels.update(phase_att_kernels(dev, kernels["lstm_cell"]))
    mark("kernels vs plain: B1-B3, B9")
    kernels.update(phase_tfd_kernels(dev))
    kernels.update(phase_train_kernels(dev))
    kernels.update(phase_layer_kernels(dev))
    mark("B4-B8")
    kernels.update(phase_image_kernel(dev))
    kernels.update(phase_chain_kernels(dev))
    mark("B10, B11")
    bf16_rec, bf16_held = phase_bf16_kernels(dev, kernels)
    kernels.update(bf16_rec)
    tf_rec, tf_held = phase_bf16_tf_kernels(dev, kernels)
    kernels.update(tf_rec)
    mark("the bf16 entries")
    cap, nmt, zh_vocab, tgt_itos, cap2nmt = build_models(dev)
    counts = phase_slice(dev, cap, nmt, zh_vocab, tgt_itos, cap2nmt,
                         {"lstm_cell": (lk, "launches"),
                          "row_topk": (tk, "launches")}, "lstm pivot")
    phase_agreement(dev, cap, nmt, cap2nmt)
    mark("lstm pivot")
    resnet_state = convert_torchvision_state_dict(
        make_torchvision_resnet("resnet101", 0), "resnet101")
    counts["image_front_end"] = phase_raw_images(dev, cap, nmt, tgt_itos,
                                                 cap2nmt, resnet_state)
    phase_resnet_agreement(dev, resnet_state)
    del resnet_state
    mark("raw-image path")
    counts.update(phase_chain_path(dev))
    mark("lstm0 fragment")
    counts["chunked_topk"] = phase_wide_beams(dev, cap, nmt, cap2nmt)
    mark("wide beams")
    dense_counts = phase_dense_decode(dev, cap, nmt, zh_vocab, cap2nmt)
    mark("denseatt decode")
    del cap, nmt
    tcap, tnmt = build_transformer_models(dev)
    tcounts = phase_slice(dev, tcap, tnmt, zh_vocab, tgt_itos, cap2nmt,
                          {"transformer_decode_stack": (tdk, "stack_launches"),
                           "row_topk": (tk, "launches")},
                          "transformer pivot")
    layer_launches = phase_layer_route(dev, tcap)
    phase_agreement_transformer(dev, tcap, tnmt, cap2nmt)
    mark("transformer pivot")
    phase_wide_transformer_nmt(dev, tnmt)
    mark("transformer NMT beam 32")
    del tcap, tnmt
    counters = {"mha_train_fwd": (mhk, "fwd_launches"),
                "mha_train_bwd": (mhk, "bwd_launches"),
                "ln_train_fwd": (lnk, "fwd_launches"),
                "ln_train_bwd": (lnk, "bwd_launches")}
    for kind in ("enc", "dec"):
        for x in ("fwd", "bwd"):
            counters[f"{kind}_layer_train_{x}"] = (ltk, f"{kind}_{x}_launches")
    runs = [phase_train(route, counters, detail=i == 0)
            for i, route in enumerate(TRAIN_ROUTES)]
    log("training routes, step wall mean / device busy: " + "; ".join(
        f"{route[0]} {wall * 1e3:.1f} ms / "
        + (f"{busy:.1f} ms" if busy is not None else "not measured")
        for route, (_, wall, busy) in zip(TRAIN_ROUTES, runs)))
    phase_train_agreement(dev, True, False)
    phase_train_agreement(dev, True, True)
    mark("transformer training")
    phase_head_widths(dev)
    mark("head widths")
    dense_counters = {"lstm_cell": (lk, "launches"),
                      "additive_attention": (aak, "launches")}
    dense_runs = [phase_train(route, dense_counters, detail=i == 0,
                              cfg_dict=DTRAIN, set_flags=_train_kernel_flag,
                              kernel_names=DENSE_KERNELS, model="denseatt")
                  for i, route in enumerate(DENSE_ROUTES)]
    log("denseatt training routes, step wall mean / device busy: "
        + "; ".join(f"{route[0]} {wall * 1e3:.1f} ms / "
                    + (f"{busy:.1f} ms" if busy is not None
                       else "not measured")
                    for route, (_, wall, busy) in zip(DENSE_ROUTES,
                                                      dense_runs)))
    phase_dense_train_agreement(dev, False)
    phase_dense_train_agreement(dev, True)
    mark("denseatt training")
    # NMT training: the BiLSTM NMT, the joint step, the transformer NMT
    cells = {"lstm_cell": (lk, "launches")}
    nmt_runs = [
        phase_train(NMT_ROUTES[0], cells, detail=False, cfg_dict=NMT_TRAIN,
                    set_flags=_train_kernel_flag, kernel_names=DENSE_KERNELS,
                    model="BiLSTM NMT", make_batch=make_nmt_batch),
        phase_train(JOINT_ROUTES[0], cells, detail=False,
                    cfg_dict=JOINT_TRAIN, set_flags=_train_kernel_flag,
                    kernel_names=DENSE_KERNELS,
                    model="denseatt + BiLSTM NMT",
                    make_batch=make_joint_batch,
                    trainer_kw=joint_trainer_kw(JOINT_TRAIN)),
        phase_train(TNMT_ROUTES[0], counters, detail=False,
                    cfg_dict=TNMT_TRAIN, model="transformer NMT",
                    make_batch=make_nmt_batch)]
    log("NMT training, step wall mean / device busy: " + "; ".join(
        f"{route[0]} {wall * 1e3:.1f} ms / "
        + (f"{busy:.1f} ms" if busy is not None else "not measured")
        for route, (_, wall, busy) in zip(
            NMT_ROUTES + JOINT_ROUTES + TNMT_ROUTES, nmt_runs)))
    mark("NMT and joint training")
    phase_attention_memory(dev)
    mark("attention memory")
    phase_nmt_train_agreement(dev, joint=False)
    phase_nmt_train_agreement(dev, joint=True)
    mark("NMT and joint card vs cpu")
    scst_counts = phase_scst(dev)
    mark("SCST")
    recipe_counts, eval_counts = phase_recipe(dev)
    mark("training CLI recipe and eval CLIs")
    raw_counts = phase_raw_data(dev)
    mark("raw data to a trained, profiled model")
    family_counts, family_cells, family_topk = phase_families(dev)
    kernels["lstm_cell"]["shapes"] += family_cells
    kernels["row_topk"]["shapes"] += family_topk
    mark("caption families (A10)")
    nmtx_counts, nmtx_cells, nmtx_topk = phase_nmt_extras(dev)
    kernels["lstm_cell"]["shapes"] += nmtx_cells
    kernels["row_topk"]["shapes"] += nmtx_topk
    mark("diverse beams and NMT extras (A10, A11)")
    phase_fork_transformer(dev)
    mark("fork transformer (A12)")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="scale-out-") as root:
        scale_counts, scale_cells, scale_topk = phase_scale_out(dev, root)
    kernels["lstm_cell"]["shapes"] += scale_cells
    kernels["row_topk"]["shapes"] += scale_topk
    mark("scale-out (A14)")
    bf16_counts, tc_counts = phase_bf16_path(dev, bf16_held, tf_held)
    mark("bf16 compute dtype (A15)")
    log_lead_in()
    log("phase seconds: " + ", ".join(
        f"{name} {t - t0:.1f}"
        for (_, t0), (name, t) in zip(marks, marks[1:])))
    dense_counts["additive_attention"] = dense_runs[1][0]["additive_attention"]
    # each training kernel's launches on the route that runs it: the default
    # route, and for the decoder-layer kernel the whole-layer route
    train_counts = {k: n for k, n in runs[0][0].items() if n}
    train_counts.update({k: n for k, n in runs[2][0].items()
                         if k.startswith("dec_layer")})
    for name, n in (list(counts.items()) + list(train_counts.items())
                    + list(dense_counts.items())):
        kernels[name]["launches"] = n
    kernels["transformer_decode_stack"]["launches"] = (
        tcounts["transformer_decode_stack"])
    # the LSTM cell's and the decoder stack's launches add the SCST steps'
    for name, n in scst_counts.items():
        kernels[name]["launches"] += n
    # and the training CLI's recipe's, the eval CLIs', the raw-data
    # pipeline's and the caption families'
    for name, n in (list(recipe_counts.items()) + list(eval_counts.items())
                    + list(raw_counts.items())
                    + list(family_counts.items())
                    + list(nmtx_counts.items())
                    + list(scale_counts.items())):
        kernels[name]["launches"] += n
    kernels["transformer_decode_layer"]["launches"] = layer_launches
    # the bf16 entries' launches: the bf16 path's
    for name, n in bf16_counts.items():
        kernels[name]["launches"] = n
    # and of them, those on the tensor-core instances (B5's also inside B6
    # / B7's bf16 calls)
    for name, n in tc_counts.items():
        if name.endswith(" in layers"):
            kernels[name[:-len(" in layers")]]["tc_launches_in_layers"] = n
        else:
            kernels[name]["tc_launches"] = n
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
