"""PyTorch port, ops/rnn.py: the LSTM cell and the stacked input-feed cell
against the JAX package on the same numpy inputs (atol 1e-5, f32).

The JAX side runs its Pallas cell in interpret mode where it routes a shape
to the kernel (aligned: d=256, h=128, b=8) and its XLA reference cell
elsewhere; the port's CPU path is the kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu.ops import rnn as jrnn
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.ops import rnn as trnn

torch.set_num_threads(1)
ATOL = 1e-5


def _cell_params(rs, d, h, g):
    scale = 1.0 / np.sqrt(h)
    return {"w": rs.uniform(-scale, scale, (d + h, g * h)).astype(np.float32),
            "b": rs.uniform(-scale, scale, (g * h,)).astype(np.float32)}


def _torch_cell(params, d, h, maxout):
    cell = trnn.init_lstm_params(d, h, maxout=maxout)
    cell.load_state_dict(bridge.params_from_jax(params))
    return cell


@pytest.mark.parametrize("maxout", [False, True])
@pytest.mark.parametrize("d,h,b", [(256, 128, 8), (100, 60, 3)],
                         ids=["aligned", "unaligned"])
def test_cell_matches_jax(maxout, d, h, b):
    rs = np.random.RandomState(d + h + b + int(maxout))
    params = _cell_params(rs, d, h, 5 if maxout else 4)
    x, h0, c0 = (rs.randn(b, n).astype(np.float32) for n in (d, h, h))
    jh, jc = jrnn.lstm_step({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                            maxout=maxout, use_pallas=True)
    cell = _torch_cell(params, d, h, maxout)
    with torch.no_grad():
        th, tc = trnn.lstm_step(cell, torch.from_numpy(x),
                                torch.from_numpy(h0), torch.from_numpy(c0),
                                maxout=maxout)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    # the reference cell is the same function
    rh, rc = trnn.lstm_step_ref(cell, torch.from_numpy(x),
                                torch.from_numpy(h0), torch.from_numpy(c0),
                                maxout=maxout)
    np.testing.assert_array_equal(rh.detach().numpy(), th.numpy())
    np.testing.assert_array_equal(rc.detach().numpy(), tc.numpy())


def test_stacked_cell_matches_jax():
    rs = np.random.RandomState(7)
    n_layers, d, h, b = 3, 32, 64, 4
    params = [_cell_params(rs, d if i == 0 else h, h, 4)
              for i in range(n_layers)]
    x = rs.randn(b, d).astype(np.float32)
    hs, cs = (rs.randn(n_layers, b, h).astype(np.float32) for _ in range(2))
    jtop, jh, jc = jrnn.stacked_lstm_step(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs))
    stack = trnn.init_stacked_lstm(n_layers, d, h)
    stack.load_state_dict(bridge.params_from_jax(params))
    with torch.no_grad():
        ttop, th, tc = trnn.stacked_lstm_step(
            stack, torch.from_numpy(x), torch.from_numpy(hs),
            torch.from_numpy(cs), dropout=0.3)   # no generator: inference
    assert th.shape == (n_layers, b, h) and tc.shape == (n_layers, b, h)
    np.testing.assert_allclose(ttop.numpy(), np.asarray(jtop), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


def test_init_params_distribution():
    """Same shapes and ranges as the JAX init_lstm_params."""
    cell = trnn.init_lstm_params(40, 30, maxout=True)
    cell.init_params(torch.Generator().manual_seed(0))
    assert tuple(cell.w.shape) == (70, 150) and tuple(cell.b.shape) == (150,)
    bound = 1.0 / np.sqrt(30)
    for p in (cell.w.detach(), cell.b.detach()):
        assert float(p.abs().max()) <= bound
        assert float(p.std()) > 0.4 * bound
