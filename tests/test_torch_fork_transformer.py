"""The port's fork transformer (`models/fork_transformer.py`) against the
JAX package's on the CPU, at 2 layers, d 16, d_inner 24, 8 heads (the
fork's head count), vocabularies 19 / 17, batch 3.

Held within 1e-5: the teacher-forced logprobs and the last layer's
attention (PAD in the source and the target), the gradient of a summed
NLL leaf by leaf, the fork's LayerNorm and positional table. Greedy
tokens are identical. The fork's traps are pinned as JAX computes them:
a source row that is all PAD gives NaN (the -inf mask), the LayerNorm
adds eps 1e-3 outside the sqrt of the unbiased variance, and the
attention's residual is the query before its projection. A fork state
dict loads through `convert_fork_transformer` as in JAX.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.models import fork_transformer as tf

torch.set_num_threads(1)
SV, TV, D, F, L, H = 19, 17, 16, 24, 2, 8
TOL = 1e-5


def _jax_model():
    import jax

    from unpaired_image_captioning_tpu.models.fork_transformer import (
        ForkTransformerNMT)

    m = ForkTransformerNMT(SV, TV, d_model=D, d_inner=F, num_layers=L,
                           num_heads=H)
    return m, m.init_params(jax.random.PRNGKey(3))


def _port(params):
    m = tf.ForkTransformerNMT(SV, TV, d_model=D, d_inner=F, num_layers=L,
                              num_heads=H, device="cpu")
    m.load_state_dict(bridge.params_from_jax(params))
    return m


def _ids(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, SV, (3, 7)).astype(np.int32)
    src[1, 5:] = 0
    src[2, 3:] = 0
    tgt = rs.randint(4, TV, (3, 6)).astype(np.int32)
    tgt[:, 0] = 2
    tgt[2, 4:] = 0
    return src, tgt


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_forward_logprobs_and_attention_match_jax():
    import jax
    import jax.numpy as jnp

    jm, jp = _jax_model()
    pm = _port(jp)
    src, tgt = _ids()
    want_lp, want_attn = jax.jit(jm.forward)(jp, jnp.asarray(src),
                                             jnp.asarray(tgt))
    got_lp, got_attn = pm(_t(src), _t(tgt))
    assert got_lp.shape == (3, 6, TV) and got_attn.shape == (3, H, 6, 7)
    np.testing.assert_allclose(got_lp.detach().numpy(), np.asarray(want_lp),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_attn.detach().numpy(),
                               np.asarray(want_attn), rtol=TOL, atol=TOL)
    # PAD source slots take no attention weight
    assert float(got_attn.detach()[2, :, :, 3:].abs().max()) == 0.0


def test_nll_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    jm, jp = _jax_model()
    pm = _port(jp)
    src, tgt = _ids(1)
    gold = np.roll(tgt, -1, axis=1)
    mask = (gold != 0).astype(np.float32)

    def nll(p):
        lp, _ = jm.forward(p, jnp.asarray(src), jnp.asarray(tgt))
        g = jnp.take_along_axis(lp, jnp.asarray(gold)[..., None], -1)[..., 0]
        return -jnp.sum(g * mask)

    want = bridge.params_from_jax(jax.jit(jax.grad(nll))(jp))
    lp, _ = pm(_t(src), _t(tgt))
    loss = -(torch.gather(lp, -1, _t(gold)[..., None])[..., 0]
             * torch.from_numpy(mask)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jax.jit(nll)(jp)),
                               rtol=TOL)
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_greedy_tokens_match_jax():
    import jax
    import jax.numpy as jnp

    jm, jp = _jax_model()
    # a sharper generator, so the argmax has no near-ties
    jp = dict(jp, generator={"w": jp["generator"]["w"] * 30.0,
                             "b": jp["generator"]["b"]})
    pm = _port(jp)
    src, _ = _ids(2)
    # the host loop traced whole: one compile instead of one per op
    want = np.asarray(jax.jit(lambda p, s: jm.translate_greedy(
        p, s, max_len=7))(jp, jnp.asarray(src)))
    got = pm.translate_greedy(_t(src), max_len=7)
    assert got.shape == (3, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():          # PAD after the first EOS
        eos = np.flatnonzero(row == 3)
        if len(eos):
            assert (row[eos[0] + 1:] == 0).all()


def test_an_all_pad_source_row_is_nan_as_in_jax():
    import jax
    import jax.numpy as jnp

    jm, jp = _jax_model()
    pm = _port(jp)
    src, tgt = _ids()
    src[0] = 0
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(src), jnp.asarray(tgt))
    got, attn = pm(_t(src), _t(tgt))
    want = np.asarray(want)
    got = got.detach().numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    assert torch.isnan(attn[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=TOL, atol=TOL)


def test_positional_table_and_layer_norm_match_jax():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models import fork_transformer as jf

    np.testing.assert_allclose(
        tf.fork_positional_encoding(40, D).numpy(),
        np.asarray(jf.fork_positional_encoding(40, D)), rtol=0, atol=TOL)
    pe = tf.fork_positional_encoding(3, 4).numpy()
    # channel i has frequency 2i/d: sin on even, cos on odd channels
    np.testing.assert_allclose(pe[2], [np.sin(2.0), np.cos(2 / 100.0),
                                       np.sin(2 / 1e4), np.cos(2 / 1e6)],
                               rtol=1e-6)
    rs = np.random.RandomState(4)
    z = rs.randn(5, D).astype(np.float32)
    a, b = rs.randn(D).astype(np.float32), rs.randn(D).astype(np.float32)
    ln = tf.ForkLayerNorm(D, device="cpu")
    ln.load_state_dict({"a_2": torch.from_numpy(a),
                        "b_2": torch.from_numpy(b)})
    got = tf.fork_layer_norm(ln, torch.from_numpy(z)).detach().numpy()
    want = np.asarray(jf.fork_layer_norm({"a_2": a, "b_2": b},
                                         jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    mu = z.mean(-1, keepdims=True)
    std = np.sqrt(((z - mu) ** 2).sum(-1, keepdims=True) / (D - 1))
    np.testing.assert_allclose(got, (z - mu) / (std + 1e-3) * a + b,
                               rtol=1e-5, atol=1e-5)


def test_attention_residual_is_the_query_before_projection():
    """With the value projection at 0 the attention adds nothing, so the
    sublayer is the LayerNorm of the raw query."""
    jm, jp = _jax_model()
    pm = _port(jp)
    mha = pm.enc[0]["self"]
    with torch.no_grad():
        mha.v.w.zero_()
    x = torch.randn(2, 4, D, generator=torch.Generator().manual_seed(0))
    out, _ = tf.fork_mha_apply(mha, x, x, x, None, n_heads=H)
    torch.testing.assert_close(out, tf.fork_layer_norm(mha.ln, x))


def test_fork_state_dict_loads_as_in_jax():
    from unpaired_image_captioning_tpu.models.convert import (
        convert_fork_transformer)

    rs = np.random.RandomState(5)

    def w(*shape):
        return rs.randn(*shape).astype(np.float32)

    state = {"encoder.embeddings.word_lut.weight": w(SV, D),
             "decoder.embeddings.word_lut.weight": w(TV, D),
             "generator.0.weight": w(TV, D), "generator.0.bias": w(TV)}
    for side in ("encoder", "decoder"):
        for i in range(L):
            p = f"{side}.transformer.{i}"
            atts = ("self_attn",) + (("context_attn",)
                                     if side == "decoder" else ())
            for a in atts:
                for n in ("query", "keys", "values"):
                    state[f"{p}.{a}.linear_{n}.weight"] = w(D, D)
                state[f"{p}.{a}.layer_norm.a_2"] = w(D)
                state[f"{p}.{a}.layer_norm.b_2"] = w(D)
            state[f"{p}.feed_forward.w_1.weight"] = w(F, D)
            state[f"{p}.feed_forward.w_1.bias"] = w(F)
            state[f"{p}.feed_forward.w_2.weight"] = w(D, F)
            state[f"{p}.feed_forward.w_2.bias"] = w(D)
            state[f"{p}.feed_forward.layer_norm.a_2"] = w(D)
            state[f"{p}.feed_forward.layer_norm.b_2"] = w(D)
    pm = tf.ForkTransformerNMT.from_fork_state_dict(state, device="cpu")
    assert (pm.num_layers, pm.d_model, pm.d_inner) == (L, D, F)
    want = bridge.params_from_jax(convert_fork_transformer(state,
                                                           num_layers=L))
    got = pm.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_head_width_must_divide():
    with pytest.raises(ValueError, match="d_model 20 is not divisible by 8"):
        tf.ForkTransformerNMT(SV, TV, d_model=20, num_heads=8, device="cpu")


def test_builds_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.ForkTransformerNMT(SV, TV, d_model=D, d_inner=F, num_layers=L)
    m = tf.ForkTransformerNMT(SV, TV, d_model=D, d_inner=F, num_layers=L,
                              device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert m.device.type == "cpu"
    assert float(m.generator.b.detach().abs().max()) == 0.0
