"""PyTorch port, `ops/attention_transforms.py` against the JAX package on
the same numpy inputs: the four transforms (softmax, sparsemax,
constrained softmax and constrained sparsemax) with and without a mask,
values within 1e-5 and the gradient of a weighted sum within
1e-4 x max(1, max |g|) (inputs with distinct values), with respect to the
logits and to the upper bounds; `matrix_tree_marginals` within 1e-4
relative, its gradient too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu.ops import attention_transforms as jat
from unpaired_image_captioning_tpu_torch.ops import attention_transforms as tat

torch.set_num_threads(1)


def _inputs(seed, n=9, rows=5):
    rs = np.random.RandomState(seed)
    z = (rs.permutation(rows * n).reshape(rows, n) * 0.173
         + rs.randn(rows, n) * 0.01).astype(np.float32)
    z = z / 3.0
    mask = np.ones((rows, n), np.float32)
    mask[1, 6:] = 0.0
    mask[3, 2:4] = 0.0
    ub = rs.uniform(0.15, 0.6, (rows, n)).astype(np.float32)
    ub[:, -1] = 100.0                       # the <SINK> column
    w = rs.randn(rows, n).astype(np.float32)
    return z, mask, ub, w


def _tol(g):
    return 1e-4 * max(1.0, float(np.abs(g).max()))


@pytest.mark.parametrize("name", sorted(tat.TRANSFORMS))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_transform_matches_jax(name, masked):
    assert sorted(tat.TRANSFORMS) == sorted(jat.TRANSFORMS)
    z, mask, ub, w = _inputs(0)
    m = mask if masked else None
    jf, tf = jat.TRANSFORMS[name], tat.TRANSFORMS[name]

    def jloss(z, ub):
        out = jf(z, mask=None if m is None else jnp.asarray(m),
                 upper_bounds=ub)
        return jnp.sum(out * w), out

    (_, jout), (gz, gu) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(z), jnp.asarray(ub))
    tz = torch.from_numpy(z).requires_grad_()
    tu = torch.from_numpy(ub).requires_grad_()
    out = tf(tz, mask=None if m is None else torch.from_numpy(m),
             upper_bounds=tu)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().sum(-1).numpy(), 1.0, atol=1e-4)
    if "constrained" in name:
        assert (out.detach() <= tu.detach() + 1e-5).all()
    assert (out.detach() >= 0).all()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz),
                               atol=_tol(np.asarray(gz)))
    gu_t = tu.grad.numpy() if tu.grad is not None else np.zeros_like(ub)
    np.testing.assert_allclose(gu_t, np.asarray(gu),
                               atol=_tol(np.asarray(gu)))


def test_constrained_transforms_bind_their_bounds():
    """Bounds below the unconstrained weights clip them: the clipped
    entries sit at their bound and the rest renormalise."""
    z = np.array([[3.0, 1.0, 0.5, -1.0, 0.0]], np.float32)
    ub = np.array([[0.3, 0.3, 0.3, 0.3, 100.0]], np.float32)
    for name in ("constrained_softmax", "constrained_sparsemax"):
        want = np.asarray(jat.TRANSFORMS[name](jnp.asarray(z),
                                                upper_bounds=jnp.asarray(ub)))
        got = tat.TRANSFORMS[name](torch.from_numpy(z),
                                   upper_bounds=torch.from_numpy(ub)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert abs(got[0, 0] - 0.3) < 1e-5


def test_matrix_tree_marginals_match_jax():
    rs = np.random.RandomState(3)
    scores = rs.randn(2, 5, 5).astype(np.float32)
    roots = rs.randn(2, 5).astype(np.float32)
    w = rs.randn(2, 5, 5).astype(np.float32)

    def jloss(s, r):
        m, rm = jat.matrix_tree_marginals(s, r)
        return jnp.sum(m * w) + jnp.sum(rm), (m, rm)

    (_, (jm, jr)), (gs, gr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(scores),
                                              jnp.asarray(roots))
    ts = torch.from_numpy(scores).requires_grad_()
    tr = torch.from_numpy(roots).requires_grad_()
    m, rm = tat.matrix_tree_marginals(ts, tr)
    ((m * torch.from_numpy(w)).sum() + rm.sum()).backward()
    for got, want in ((m, jm), (rm, jr), (ts.grad, gs), (tr.grad, gr)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # every child has one parent: marginals sum to 1 over parents + root
    np.testing.assert_allclose((m.sum(1) + rm).detach().numpy(), 1.0,
                               atol=1e-4)
