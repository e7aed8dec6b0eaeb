"""PyTorch port, ops/transformer_decode.py: the plain decoder step (one
layer and the whole stack) against the JAX package's Pallas kernels
`decoder_layer_step` / `decoder_stack_step`, run in interpret mode as the
JAX package's own tests run them, on the same packed weights (carried over
by bridge.params_from_jax) and the same numpy inputs; and, on a CUDA card,
the CUDA kernel against the plain version at the serving paths' shapes.

Tolerance: atol and rtol 2e-5 on x', the caches and the attention weights,
the JAX package's own for kernel vs step (tests/test_transformer.py).

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_transformer_decode.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import (
    transformer_decode as tdk)
from unpaired_image_captioning_tpu_torch.ops import transformer_decode as td

torch.set_num_threads(1)

D, H, DFF, T, S = 32, 4, 48, 7, 6
TOL = dict(atol=2e-5, rtol=2e-5)


def _models(n_layers, heads=H):
    """JAX and port caption transformers on the same parameters."""
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu_torch import bridge
    from unpaired_image_captioning_tpu_torch import models as tmodels

    cfg = Config(caption_model="transformer", vocab_size=21, rnn_size=DFF,
                 num_layers=n_layers, input_encoding_size=D, att_hid_size=16,
                 fc_feat_size=10, att_feat_size=12, seq_length=T,
                 drop_prob_lm=0.0, num_heads=heads)
    jp = jmodels.setup(cfg).init_params(jax.random.PRNGKey(n_layers))
    tm = tmodels.setup(cfg, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    # non-trivial LayerNorm parameters and biases (the init is 1 / 0)
    rs = np.random.RandomState(n_layers)
    with torch.no_grad():
        for name, p in tm.dec.named_parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(
                    0.1 * rs.randn(*p.shape).astype(np.float32)))
    return bridge.params_to_numpy(tm)["dec"], tm


def _ancestry(rs, bsz, kb, t_now):
    """anc [R, T] of a random beam history over steps 0..t_now-1, updated
    as onmt_beam_search does: anc'[k, tau <= t] = anc[parent(k), tau],
    anc'[k, tau > t] = k."""
    local = np.arange(bsz * kb) % kb
    anc = np.repeat(local[:, None], T, axis=1)
    base = (np.arange(bsz) * kb)[:, None]
    for step in range(t_now):
        parent = rs.randint(0, kb, (bsz, kb))
        re = anc[(base + parent).reshape(-1)]
        anc = np.where(np.arange(T)[None, :] <= step, re, local[:, None])
    return anc.astype(np.int32)


def _inputs(seed, bsz, kb, n_layers, *, stagger=True, slots=S):
    rs = np.random.RandomState(seed)
    rows = bsz * kb
    f = np.float32
    t = (rs.randint(0, T, rows) if stagger else np.full(rows, 4)).astype(np.int32)
    if stagger:
        t[0] = 0
        t[-1] = T - 1
    mask = np.ones((bsz, slots), f)
    mask[0, 3:] = 0.0                       # padded source slots
    mask[-1, 5:] = 0.0
    return dict(x=rs.randn(rows, D).astype(f), t=t,
                ck=rs.randn(n_layers, bsz, slots, D).astype(f),
                cv=rs.randn(n_layers, bsz, slots, D).astype(f), mask=mask,
                kc=rs.randn(rows, n_layers, T, D).astype(f),
                vc=rs.randn(rows, n_layers, T, D).astype(f))


# (heads, bsz, kb, S, edit, lazy): the edges of the CUDA kernels' tiling,
# on the plain step: rows at t >= T, a row at t = -1 (one beam, where the
# Pallas kernel's all-masked softmax also spans only the row's own T
# slots), a fully masked image, 7 images x 3 beams, head widths 4, 16 and
# 32, an odd S
EDGE_CASES = {
    "t_beyond": (H, 2, 3, S, "t_beyond", False),
    "t_beyond_lazy": (H, 2, 3, S, "t_beyond", True),
    "t_minus1_kb1": (H, 3, 1, S, "t_minus1", False),
    "masked_image": (H, 2, 3, S, "masked", False),
    "rows7x3": (H, 7, 3, S, None, False),
    "dh4": (8, 2, 3, S, None, False),
    "dh16": (2, 2, 3, S, None, False),
    "dh32": (1, 2, 3, S, None, False),
    "slots5": (H, 2, 3, 5, None, False),
}
LAYER_CASES = {"kb1": (H, 3, 1, S, None, False),
               "kb3": (H, 2, 3, S, None, False),
               **{c: v for c, v in EDGE_CASES.items() if not v[5]}}
STACK_CASES = {"full": (H, 2, 3, S, None, False),
               "lazy-anc": (H, 2, 3, S, None, True), **EDGE_CASES}


def _case_inputs(spec, seed, n_layers):
    """`_inputs` for a case, its edit applied, and its `anc` if lazy."""
    _, bsz, kb, slots, edit, lazy = spec
    a = _inputs(seed, bsz, kb, n_layers, stagger=not lazy, slots=slots)
    if edit == "t_beyond":
        a["t"][:2] = [T, T + 3]
    elif edit == "t_minus1":
        a["t"][1] = -1
    elif edit == "masked":
        a["mask"][1] = 0.0
    anc = _ancestry(np.random.RandomState(3), bsz, kb, 4) if lazy else None
    return a, anc


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_step_matches_jax_kernel(case):
    """One layer, per-row staggered t (a row at t = 0 and one at T - 1) and
    a padded src_mask, over two consecutive steps; then the edge cases."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    heads, _, kb = LAYER_CASES[case][:3]
    jdec, tm = _models(2, heads)
    a, _ = _case_inputs(LAYER_CASES[case], kb, 1)
    jw = jtd.pack_layer_weights(jax_tree(jdec[1]))
    tw = td.pack_layer_weights(tm.dec[1])
    jx, jk, jv = (jnp.asarray(a["x"]), jnp.asarray(a["kc"][:, 0]),
                  jnp.asarray(a["vc"][:, 0]))
    tx, tk, tv = (torch.from_numpy(a["x"]), torch.from_numpy(a["kc"][:, 0]),
                  torch.from_numpy(a["vc"][:, 0]))
    t = a["t"]
    for _ in range(2):
        jx, jk, jv = jtd.decoder_layer_step(
            jx, jnp.asarray(t), jnp.asarray(a["ck"][0]),
            jnp.asarray(a["cv"][0]), jnp.asarray(a["mask"]), jk, jv, jw,
            n_heads=heads, interpret=True)
        k_in = tk
        tx, tk, tv = tdk.decoder_layer_step(
            tx, torch.from_numpy(t), torch.from_numpy(a["ck"][0]),
            torch.from_numpy(a["cv"][0]), torch.from_numpy(a["mask"]), tk,
            tv, tw, n_heads=heads)
        assert tk is k_in                     # the cache is written in place
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        t = np.minimum(t + 1, T - 1).astype(np.int32)


def jax_tree(tree):
    """numpy tree -> jnp tree."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_step_matches_jax_kernel(case):
    """All L = 3 layers. Full mode: kb 3, per-row staggered t, padded
    src_mask. Lazy mode: kb 3, one t for all rows, `anc` from a real beam
    history, and the last layer's mean-head attention (`want_attn`). Then
    the edge cases, each with `want_attn`."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    heads, bsz, kb, _, _, lazy = STACK_CASES[case]
    want_attn = case != "full"
    n_layers = 3
    jdec, tm = _models(n_layers, heads)
    a, anc = _case_inputs(STACK_CASES[case], 10 + lazy, n_layers)
    if lazy:
        assert (anc != np.arange(bsz * kb)[:, None] % kb).any()
    jw = jtd.pack_stack_weights(jax_tree(jdec))
    tw = td.pack_stack_weights(tm.dec)
    jout = jtd.decoder_stack_step(
        jnp.asarray(a["x"]), jnp.asarray(a["t"]), jnp.asarray(a["ck"]),
        jnp.asarray(a["cv"]), jnp.asarray(a["mask"]), jnp.asarray(a["kc"]),
        jnp.asarray(a["vc"]), jw,
        None if anc is None else jnp.asarray(anc), n_heads=heads,
        interpret=True, want_attn=want_attn)
    tout = tdk.decoder_stack_step(
        torch.from_numpy(a["x"]), torch.from_numpy(a["t"]),
        torch.from_numpy(a["ck"]), torch.from_numpy(a["cv"]),
        torch.from_numpy(a["mask"]), torch.from_numpy(a["kc"].copy()),
        torch.from_numpy(a["vc"].copy()), tw,
        None if anc is None else torch.from_numpy(anc), n_heads=heads,
        want_attn=want_attn)
    assert len(tout) == len(jout) == (4 if want_attn else 3)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if lazy:
        np.testing.assert_array_equal(tout[3].argmax(-1).numpy(),
                                      np.asarray(jout[3]).argmax(-1))


def test_pack_matches_jax_without_sublane_padding():
    """The port's packing is the JAX package's, with the [1, X] -> [8, X]
    sublane padding of the TPU stack layout dropped."""
    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    jdec, tm = _models(2)
    jw = jtd.pack_stack_weights(jax_tree(jdec))
    tw = td.pack_stack_weights(tm.dec)
    assert tuple(jtd._WKEYS) == td.WKEYS
    for k in td.WKEYS:
        want = np.asarray(jw[k])
        if k in jtd._VEC_WKEYS:
            want = want[:, 0]
        np.testing.assert_array_equal(tw[k].numpy(), want)


def test_slot_beyond_cache_writes_nothing():
    """A row whose t is past the cache writes no slot and attends over all
    T positions (the JAX kernel's `col == t` write and `col <= t` mask)."""
    _, tm = _models(2)
    a = _inputs(5, 2, 1, 2)
    a["t"][0] = T + 3
    kc = torch.from_numpy(a["kc"].copy())
    tdk.decoder_stack_step(
        torch.from_numpy(a["x"]), torch.from_numpy(a["t"]),
        torch.from_numpy(a["ck"]), torch.from_numpy(a["cv"]), None, kc,
        torch.from_numpy(a["vc"].copy()), td.pack_stack_weights(tm.dec),
        n_heads=H)
    np.testing.assert_array_equal(kc[0].numpy(), a["kc"][0])
    assert not np.array_equal(kc[1].numpy(), a["kc"][1])


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,match", [
    ((250, 50, 512, 512, 8, 196, 16), None),
    ((750, 50, 512, 2048, 8, 16, 20), None),
    ((10, 3, 512, 512, 8, 196, 16), "whole number"),
    ((10, 5, 512, 512, 3, 196, 16), "heads"),
    ((10, 5, 24, 48, 4, 196, 16), None),             # dh = 6
    ((10, 5, 512, 512, 2, 196, 16), None),           # dh = 256
    ((10, 5, 520, 512, 2, 196, 16), None),           # dh = 260
    ((64, 2, 512, 512, 2, 196, 16), None),           # 32 beams, dh 256
    ((10, 5, 512, 510, 8, 196, 16), None),           # d_ff 510
    ((10, 5, 512, 512, 8, 196, 4000), None),         # a chunked cache
    ((640, 5, 512, 512, 4, 100000, 16), None),       # slots in pieces
    ((10, 5, 8192, 512, 1, 196, 16), None),          # one head of 8,192
], ids=["caption", "nmt", "rows", "heads", "dh6", "dh256", "dh260",
        "beam32_dh256", "dff", "T", "S", "dh8192"])
def test_check_dims_names_what_the_kernels_do_not_take(cuda_dev, dims,
                                                       match):
    """The wrapper's shape checks, run before a launch (the C entries
    apply the same): every shape the JAX package computes is taken, heads
    of any width too."""
    if match is None:
        tdk._check_dims("step", *dims)
    else:
        with pytest.raises(ValueError, match=match):
            tdk._check_dims("step", *dims)


def _card_inputs(dev, bsz, kb, n_layers, n_t, slots, d, dff, lazy):
    g = torch.Generator(device=dev).manual_seed(bsz * kb + n_t)
    rows = bsz * kb

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    mats = {"wqkv": (d, 3 * d), "wo_s": (d, d), "wq_c": (d, d),
            "wo_c": (d, d), "w1": (d, dff), "w2": (dff, d)}
    w = {k: (rnd(n_layers, *mats[k], scale=mats[k][0] ** -0.5)
             if k in mats else
             rnd(n_layers, {"bqkv": 3 * d, "b1": dff}.get(k, d), scale=0.1)
             + (1.0 if k.startswith("ln") and k.endswith("_s") else 0.0))
         for k in td.WKEYS}
    mask = torch.ones((bsz, slots), device=dev)
    mask[1, slots // 2:] = 0.0
    if lazy:
        t = torch.full((rows,), n_t - 3, dtype=torch.int32, device=dev)
        anc = torch.randint(0, kb, (rows, n_t), generator=g, device=dev,
                            dtype=torch.int32)
    else:
        t = torch.randint(0, n_t, (rows,), generator=g, device=dev,
                          dtype=torch.int32)
        anc = None
    return dict(w=w, x=rnd(rows, d), t=t, ck=rnd(n_layers, bsz, slots, d),
                cv=rnd(n_layers, bsz, slots, d), mask=mask,
                kc=rnd(rows, n_layers, n_t, d), vc=rnd(rows, n_layers, n_t, d),
                anc=anc)


def _edit(a, edit, n_t):
    """Rows at t = -1, T and T + 3 ("t_out"), or image 1 with every slot
    masked ("masked")."""
    if edit == "t_out":
        a["t"][:3] = torch.tensor([-1, n_t, n_t + 3], dtype=torch.int32)
    elif edit == "masked":
        a["mask"][1] = 0.0
    return a


# (bsz, kb, T, S, d, d_ff, heads, lazy, edit): the serving paths' two
# shapes, a tiny ragged one, and the edges of the kernels' tiling: rows not
# a multiple of the GEMM's 64-row tile, S not a multiple of the
# cross-attention's slot split, rows with t = -1 and t >= T, a fully masked
# image, head widths 32, 96, 128 and 256 (at 32 beams the cross-attention
# splits the beams into two query groups), one beam
CUDA_CASES = {
    "caption": (50, 5, 16, 196, 512, 512, 8, False, None),
    "nmt": (50, 15, 20, 16, 512, 2048, 8, True, None),
    "ragged": (3, 2, 7, 5, 32, 48, 8, False, None),
    "rows7x3": (7, 3, 16, 196, 512, 512, 8, False, None),
    "slots197": (4, 5, 16, 197, 512, 512, 8, False, None),
    "t_outside": (4, 5, 16, 196, 512, 512, 8, False, "t_out"),
    "t_outside_lazy": (4, 15, 20, 16, 512, 2048, 8, True, "t_out"),
    "masked_image": (4, 5, 16, 196, 512, 512, 8, False, "masked"),
    "dh32": (4, 5, 16, 196, 512, 512, 16, False, None),
    "dh128": (4, 5, 16, 196, 512, 512, 4, False, None),
    "dh96": (4, 5, 16, 196, 768, 512, 8, False, None),
    "dh256": (4, 5, 16, 196, 512, 512, 2, False, None),
    "dh256_nmt": (4, 15, 20, 16, 512, 2048, 2, True, None),
    "dh256_beam32": (2, 32, 16, 196, 512, 512, 2, False, "t_out"),
    "kb1": (9, 1, 16, 196, 512, 512, 8, False, None),
    "scst_batch50_kb1": (50, 1, 16, 196, 512, 512, 8, False, None),
    # widths off 16 bytes (scalar instances), heads past 256, a d_ff of
    # 510, a cache chunked in the self-attention, slots walked in pieces
    "dh6": (4, 5, 16, 196, 12, 40, 2, False, None),
    "dh50_lazy": (4, 15, 20, 16, 100, 200, 2, True, "t_out"),
    "d30": (3, 2, 7, 5, 30, 45, 5, False, "t_out"),
    "dh384": (4, 5, 16, 196, 384, 384, 1, False, None),
    "dh512": (4, 5, 16, 196, 512, 512, 1, False, "masked"),
    "dh512_nmt": (4, 15, 20, 16, 512, 2048, 1, True, None),
    "dff510": (4, 5, 16, 196, 512, 510, 8, False, None),
    "T4000": (2, 2, 4000, 16, 512, 512, 1, False, None),
    "S100000": (2, 5, 16, 100000, 64, 64, 2, True, None),
    # heads past what a block held whole: q in column chunks in the
    # self-attention (past 7,200 columns), one row a block in the
    # cross-attention (past pieces' reach: 6,000 columns over 500 slots)
    "dh7300": (2, 2, 8, 8, 7300, 64, 1, False, None),
    "dh6000_S500": (2, 2, 8, 500, 6000, 64, 1, False, "t_out"),
    "dh7302_odd": (2, 2, 8, 8, 7302, 64, 1, False, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_decoder_step_matches_plain(cuda_dev, case):
    bsz, kb, n_t, slots, d, dff, heads, lazy, edit = CUDA_CASES[case]
    n_layers = 6 if case in ("caption", "nmt", "ragged",
                             "scst_batch50_kb1") else 2
    a = _edit(_card_inputs(cuda_dev, bsz, kb, n_layers, n_t, slots, d, dff,
                           lazy), edit, n_t)
    want_attn = lazy or edit is not None
    tol = dict(atol=1e-4, rtol=1e-4)   # f32 sums in another order
    kk, vk, kp, vp = (c.clone() for c in (a["kc"], a["vc"], a["kc"], a["vc"]))
    before = tdk.stack_launches
    got = tdk.decoder_stack_step(a["x"], a["t"], a["ck"], a["cv"], a["mask"],
                                 kk, vk, a["w"], a["anc"], n_heads=heads,
                                 want_attn=want_attn)
    want = td.decoder_stack_step_plain(a["x"], a["t"], a["ck"], a["cv"],
                                       a["mask"], kp, vp, a["w"], a["anc"],
                                       n_heads=heads, want_attn=want_attn)
    torch.cuda.synchronize()
    assert tdk.stack_launches == before + 1
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, **tol)
    w0 = {k: v[0].contiguous() for k, v in a["w"].items()}
    lk_, lv_, lkp, lvp = (c[:, 0].contiguous()
                          for c in (a["kc"], a["vc"], a["kc"], a["vc"]))
    before = tdk.layer_launches
    got = tdk.decoder_layer_step(a["x"], a["t"], a["ck"][0].contiguous(),
                                 a["cv"][0].contiguous(), a["mask"], lk_, lv_,
                                 w0, n_heads=heads)
    want = td.decoder_layer_step_plain(a["x"], a["t"], a["ck"][0], a["cv"][0],
                                       a["mask"], lkp, lvp, w0,
                                       n_heads=heads)
    torch.cuda.synchronize()
    assert tdk.layer_launches == before + 1
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["caption", "nmt"])
def test_cuda_stack_step_is_deterministic(cuda_dev, case):
    """Two runs of the stack step with want_attn on copies of the same
    caches give the same bits: x', both caches and the mean-head weights
    (the NMT's UNK replacement takes their argmax)."""
    bsz, kb, n_t, slots, d, dff, heads, lazy, _ = CUDA_CASES[case]
    a = _card_inputs(cuda_dev, bsz, kb, 6, n_t, slots, d, dff, lazy)
    outs = [tdk.decoder_stack_step(a["x"], a["t"], a["ck"], a["cv"],
                                   a["mask"], a["kc"].clone(),
                                   a["vc"].clone(), a["w"], a["anc"],
                                   n_heads=heads, want_attn=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for p, q in zip(*outs):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_cuda_decoder_step_rejects_bad_input(cuda_dev):
    a = _card_inputs(cuda_dev, 2, 2, 1, 5, 4, 32, 48, False)
    with pytest.raises(ValueError, match="int32"):
        tdk.decoder_stack_step(a["x"], a["t"].long(), a["ck"], a["cv"],
                               a["mask"], a["kc"], a["vc"], a["w"], n_heads=4)
    with pytest.raises(ValueError, match="heads"):
        tdk.decoder_stack_step(a["x"], a["t"], a["ck"], a["cv"], a["mask"],
                               a["kc"], a["vc"], a["w"], n_heads=3)


def _scaled(got, want, tol=1e-2):
    """bf16: max|diff| <= tol * max(1, max|plain|), types equal."""
    assert got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert ((got - want).abs().max().item()
            <= tol * max(1.0, want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("mix", tdk.MIXTURES[1:], ids="/".join)
@pytest.mark.parametrize("case", ["caption", "scst_batch50_kb1", "nmt",
                                  "t_outside", "d30"])
def test_cuda_decoder_step_bf16_matches_plain(cuda_dev, case, mix):
    """The bf16 entries (x, the weights, the caches, the memory each f32 or
    bf16: `tdk.MIXTURES`) against the plain version at rtol = atol = 1e-2
    against the output's scale, stack and layer, each counted as a bf16
    launch."""
    bsz, kb, n_t, slots, d, dff, heads, lazy, edit = CUDA_CASES[case]
    a = _edit(_card_inputs(cuda_dev, bsz, kb, 2, n_t, slots, d, dff, lazy),
              edit, n_t)
    tx, tw, tc, tm = (torch.bfloat16 if m == "bf16" else torch.float32
                      for m in mix)
    w = {k: v.to(tw) for k, v in a["w"].items()}
    x, ck, cv = a["x"].to(tx), a["ck"].to(tm), a["cv"].to(tm)
    kc, vc = a["kc"].to(tc), a["vc"].to(tc)
    before = tdk.bf16_stack_launches
    got = tdk.decoder_stack_step(x, a["t"], ck, cv, a["mask"], kc.clone(),
                                 vc.clone(), w, a["anc"], n_heads=heads,
                                 want_attn=lazy)
    want = td.decoder_stack_step_plain(x, a["t"], ck, cv, a["mask"],
                                       kc.clone(), vc.clone(), w, a["anc"],
                                       n_heads=heads, want_attn=lazy)
    torch.cuda.synchronize()
    assert tdk.bf16_stack_launches == before + 1
    for g_, w_ in zip(got, want):
        _scaled(g_, w_)
    w0 = {k: v[0].contiguous() for k, v in w.items()}
    args = (x, a["t"], ck[0].contiguous(), cv[0].contiguous(), a["mask"])
    got = tdk.decoder_layer_step(*args, kc[:, 0].contiguous(),
                                 vc[:, 0].contiguous(), w0, n_heads=heads)
    want = td.decoder_layer_step_plain(*args, kc[:, 0].contiguous(),
                                       vc[:, 0].contiguous(), w0,
                                       n_heads=heads)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        _scaled(g_, w_)
