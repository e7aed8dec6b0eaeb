#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `unpaired_image_captioning_tpu_torch/
csrc/`, holds each kernel against its plain PyTorch version at the serving
path's shapes, then serves the pivot task (image features -> zh caption by
denseatt beam 5 -> en by BiLSTM NMT beam 15) at full width with random
weights made from seed 0: 40 concurrent requests to `PivotService` and one
`POST /pivot` through the HTTP front end. It checks that the path launched
both kernels, compares four images against the same models on the CPU, and
prints, as its last line, `{"ok": true, "device": {...}}`.

Numerics: f32 throughout, with TF32 off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`).

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
N_SLOTS = 196               # 14 x 14 attention grid per image
CAP_BEAM, NMT_BEAM, NMT_MAX_LEN = 5, 15, 20
N_REQUESTS, MAX_BATCH, BENCH_BATCH = 40, 32, 50

LSTM_TOL = 1e-4   # f32 sums in another order than cuBLAS; TF32 off
AGREE_TOL = 1e-3  # card vs CPU over whole f32 models: sums in other orders

# (label, B, D, H, maxout): the cells of the path at their beam batches
LSTM_SHAPES = [
    ("denseatt lstm0/1/2, beam 5 x 50", 250, 1024, 512, True),
    ("nmt encoder, per direction", 50, 512, 256, False),
    ("nmt decoder, beam 15 x 50", 750, 1024, 512, False),
    ("ragged", 3, 100, 60, False),
    ("ragged maxout", 3, 100, 60, True),
]
# (label, R, V, k): beam selection rows of the path, then the k domain edges
TOPK_SHAPES = [
    ("caption beam 5 x 50", 250, 9488, 5),
    ("nmt beam 15 x 50", 750, 8571, 15),
    ("caption beam 3 x 50", 150, 9488, 3),
    ("k=1", 250, 9488, 1),
    ("k=2", 250, 9488, 2),
    ("k=16", 250, 9488, 16),
]


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
    """Run `run()` under torch.profiler and return the device time of each
    CUDA kernel name, in microseconds. A session that records no device
    event is repeated once; after that the result is None and the caller
    times with CUDA events instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        per_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = (per_name.get(e.name, 0.0)
                                    + e.time_range.elapsed_us())
        if per_name:
            return per_name
    return None


def device_ms(fn):
    """Device time of one call of `fn` (after one warm-up call): the summed
    durations of the CUDA kernels it launches, as torch.profiler records
    them, or None if the profiler recorded none. Unlike `time_ms` it leaves
    out the host's launch overhead."""
    fn()
    per_name = _profile_device_us(fn)
    return None if per_name is None else sum(per_name.values()) / 1e3


def time_pair(kernel_fn, plain_fn, kernel_name: str, iters: int = 20):
    """Kernel and plain times, taken in turns: (kernel ms, plain ms, kernel
    wall ms per call, plain wall ms per call, how the first two were read).
    The first two are device times from one profiler session in which the
    two alternate, the kernel's events told apart by `kernel_name`; if the
    profiler records no device time they are the CUDA-event times. Wall
    times come from CUDA events around back-to-back calls (plain, kernel,
    kernel, plain)."""
    kernel_fn()
    plain_fn()

    def run():
        for _ in range(iters):
            plain_fn()
            kernel_fn()

    per_name = _profile_device_us(run) or {}
    k_us = sum(v for n, v in per_name.items() if kernel_name in n)
    p_us = sum(v for n, v in per_name.items() if kernel_name not in n)
    p1, k1, k2, p2 = (time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn,
                                            plain_fn))
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
    log(card)
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

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk

    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    lstm_err, lstm_ms, lstm_plain_ms = 0.0, None, None
    for label, b, d, h, maxout in LSTM_SHAPES:
        g = 5 if maxout else 4
        scale = 1.0 / h ** 0.5
        w = (torch.rand((d + h, g * h), generator=gen, device=dev) * 2 - 1) * scale
        bias = (torch.rand((g * h,), generator=gen, device=dev) * 2 - 1) * scale
        x = torch.randn((b, d), generator=gen, device=dev)
        h0 = torch.randn((b, h), generator=gen, device=dev)
        c0 = torch.randn((b, h), generator=gen, device=dev)
        hk, ck = lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout)
        hp, cp = lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout)
        torch.cuda.synchronize()
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        if not err <= LSTM_TOL:
            raise AssertionError(f"lstm_cell {label}: max|diff| {err} > {LSTM_TOL}")
        k_ms, p_ms, k_wall, p_wall, how = time_pair(
            lambda: lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout),
            lambda: lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout),
            "lstm_cell_kernel")
        lstm_err = max(lstm_err, err)
        if lstm_ms is None:
            lstm_ms, lstm_plain_ms, lstm_how = k_ms, p_ms, how
        log(f"kernel lstm_cell G={g} [{b}, {d}->{h}] ({label}): "
            f"max|diff| {err:.3g} (tol {LSTM_TOL}); {how}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per call kernel "
            f"{k_wall:.4f} ms, plain {p_wall:.4f} ms")
    rec["lstm_cell"] = {
        "name": "lstm_cell", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/rnn.py:72",
        "max_abs_err": lstm_err, "ms": lstm_ms, "plain_ms": lstm_plain_ms,
        "shape": "G=5 [250, 1024->512]", "timing": lstm_how}

    topk_ms, topk_plain_ms = None, None
    for label, r, v, k in TOPK_SHAPES:
        x = torch.randn((r, v), generator=gen, device=dev)
        x[:20] = torch.round(x[:20] * 2) / 2              # many exact ties
        x[20:25] = float("-inf")                          # all -inf rows
        x[25:30] = float("-inf")                          # -inf tails
        x[25:30, 7] = 1.0
        x[25:30, v - 1] = 1.0
        x[30:35] = -1e10                                  # dead beam rows
        vk, ik = tk.row_topk(x, k)
        vp, ip = tk.row_topk_plain(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(vk, vp) and torch.equal(ik, ip)):
            bad = (ik != ip).any(dim=1).nonzero()[:5, 0].tolist()
            raise AssertionError(f"row_topk {label}: differs from the stable "
                                 f"sort in rows {bad}")
        k_ms, p_ms, k_wall, p_wall, how = time_pair(
            lambda: tk.row_topk(x, k), lambda: tk.row_topk_plain(x, k),
            "row_topk_kernel")
        if topk_ms is None:
            topk_ms, topk_plain_ms, topk_how = k_ms, p_ms, how
        log(f"kernel row_topk [{r}, {v}] k={k} ({label}): exact "
            f"(values and indices equal); {how}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms; per call kernel {k_wall:.4f} ms, "
            f"plain {p_wall:.4f} ms")
    rec["row_topk"] = {
        "name": "row_topk", "route": "cuda",
        "source": "unpaired_image_captioning_tpu_torch/csrc/row_topk.cu",
        "replaces": "unpaired_image_captioning_tpu/ops/topk.py:145",
        "max_abs_err": 0.0, "ms": topk_ms, "plain_ms": topk_plain_ms,
        "shape": "[250, 9488] k=5", "timing": topk_how}
    return rec


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
    v, src_v = CAP["vocab_size"], NMT["src_vocab_size"]
    zh_vocab = {str(i): f"zh{i}" for i in range(1, v + 1)}
    tgt_itos = {i: f"en{i}" for i in range(NMT["tgt_vocab_size"])}
    # caption id -> NMT source id: PAD for 0, UNK (1) for every 50th word
    cap2nmt = np.zeros((v + 1,), np.int64)
    ids = np.arange(1, v + 1)
    cap2nmt[1:] = np.where(ids % 50 == 0, 1, 4 + (ids - 1) % (src_v - 4))
    return cap, nmt, zh_vocab, tgt_itos, cap2nmt


def make_features(rs, n: int):
    fc = rs.randn(n, CAP["fc_feat_size"]).astype(np.float32)
    att = rs.randn(n, N_SLOTS, CAP["att_feat_size"]).astype(np.float32)
    return fc, att


def phase_slice(dev, cap, nmt, zh_vocab, tgt_itos, cap2nmt) -> dict:
    """Serve the pivot task at full width through PivotService and HTTP;
    returns the kernels' launch counts during the run."""
    import torch

    from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
    from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
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
        lk.launches = 0
        tk.launches = 0
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
        counts = {"lstm_cell": lk.launches, "row_topk": tk.launches}
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
            raise AssertionError(f"the slice never launched kernel {name}")
    lat_ms = sorted(x * 1e3 for x in latency)
    log(f"slice: {N_REQUESTS} concurrent requests in {batches} micro-batches "
        f"({wall:.2f} s wall), latency p50 {statistics.median(lat_ms):.1f} ms,"
        f" max {lat_ms[-1]:.1f} ms; HTTP /pivot == direct; launches "
        f"lstm_cell {counts['lstm_cell']}, row_topk {counts['row_topk']}")
    log(f"slice: sample answer {json.dumps(answers[0], ensure_ascii=False)}")

    # throughput of one batch-50 pivot_translate (after one warm-up call)
    bfc, batt = make_features(rs, BENCH_BATCH)
    bf = feats(bfc, batt)
    zh, en, aux = pivot_translate(cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM,
                                  nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zh, en, aux = pivot_translate(cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM,
                                  nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = {"zh": (BENCH_BATCH, CAP["seq_length"]),
            "en": (BENCH_BATCH, NMT_MAX_LEN), "aux": (BENCH_BATCH, NMT_MAX_LEN)}
    for name, t in (("zh", zh), ("en", en), ("aux", aux)):
        if tuple(t.shape) != want[name]:
            raise AssertionError(f"pivot {name} shape {tuple(t.shape)}")
    if not (int(zh.min()) >= 0 and int(zh.max()) <= CAP["vocab_size"]
            and int(en.min()) >= 0 and int(en.max()) < NMT["tgt_vocab_size"]
            and int(aux.min()) >= 0 and int(aux.max()) < CAP["seq_length"]):
        raise AssertionError("pivot ids out of range")
    busy = device_ms(lambda: pivot_translate(
        cap, nmt, bf, cap2nmt_t, cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
        nmt_max_len=NMT_MAX_LEN))
    busy_msg = ("device busy not measured (the profiler recorded no device "
                "time)" if busy is None else
                f"device busy {busy:.1f} ms (kernel time), idle share "
                f"{1 - busy / (secs * 1e3):.2f}")
    log(f"slice: batch-{BENCH_BATCH} pivot_translate {secs * 1e3:.1f} ms, "
        f"{BENCH_BATCH / secs:.1f} images/s; {busy_msg}")
    return counts


def _nmt_teacher_forced(nmt, src, lengths, tgt):
    """NMT step logprobs [B, T, V] along the given target tokens."""
    import torch

    from unpaired_image_captioning_tpu_torch.ops.masking import length_mask

    dec = nmt.decoder
    ctx, hid = nmt.encoder.apply(src, lengths)
    state = dec.init_state(hid, ctx)
    mask = length_mask(lengths, src.shape[1])
    out = []
    for t in range(tgt.shape[1]):
        o, _, state = dec.step(ctx, state, tgt[:, t], src_mask=mask)
        out.append(torch.log_softmax(nmt.generator_logits(o), -1))
    return ctx, torch.stack(out, 1)


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
        tgt = torch.cat([torch.full((n, 1), 2, dtype=torch.long), en[:, :-1]], 1)
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

    for part in ("cap", "nmt"):
        g, c = res["gpu"][part], res["cpu"][part]
        gs, cs = g.seq[:, 0].cpu(), c.seq[:, 0]
        same = (gs == cs).float().mean().item()
        msg = (f"agreement: {'zh' if part == 'cap' else 'en'} top-beam tokens "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    # the port must come from this checkout; fail before printing otherwise
    import unpaired_image_captioning_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_device()
    phase_build()
    kernels = phase_kernels(dev)
    models = build_models(dev)
    counts = phase_slice(dev, *models)
    phase_agreement(dev, models[0], models[1], models[4])
    for name, n in counts.items():
        kernels[name]["launches"] = n
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
