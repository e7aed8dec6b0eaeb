"""The port's image front end (`kernels/image.py`, plain version in
`ops/image.py`) against the JAX package's `resize_normalize` on its Pallas
route (interpret mode on the CPU): a downscale, an upscale, the identity
and one channel, at 1e-5 absolute (the same weights, products summed in
another order). At the identity the plain version equals the host's
`preprocess_images` bit for bit.

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_image.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import image as ik
from unpaired_image_captioning_tpu_torch.ops import image as io

TOL = 1e-5


def _imgs(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape,h_out,w_out", [
    ((2, 30, 40, 3), 16, 24),      # downscale, non-integer ratios
    ((2, 12, 10, 3), 29, 31),      # upscale
    ((2, 16, 20, 3), 16, 20),      # identity (the loader's case)
    ((1, 14, 9, 1), 11, 13),       # one channel: the statistics' means
    ((2, 31, 45, 3), 17, 23),      # rows of Wo * C = 69: not whole float4
    ((1, 9, 11, 4), 6, 7),         # four channels
], ids=["down", "up", "identity", "c1", "tail", "c4"])
def test_plain_matches_pallas_interpret(shape, h_out, w_out):
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.image import resize_normalize

    imgs = _imgs(shape, sum(shape))
    want = resize_normalize(jnp.asarray(imgs), h_out=h_out, w_out=w_out,
                            use_pallas=True)
    got = ik.resize_normalize(torch.from_numpy(imgs), h_out=h_out,
                              w_out=w_out)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], h_out, w_out, shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_identity_is_preprocess_images_bit_for_bit():
    from unpaired_image_captioning_tpu.models.resnet import (
        preprocess_images as jax_preprocess)

    imgs = _imgs((3, 21, 17, 3), 7)
    got = ik.resize_normalize(torch.from_numpy(imgs), h_out=21, w_out=17)
    host = io.preprocess_images(imgs)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(host, jax_preprocess(imgs))


@pytest.mark.parametrize("n_in,n_out", [(480, 448), (448, 448), (375, 448),
                                        (5, 3), (3, 7), (1, 4)])
def test_taps_rebuild_the_matrix(n_in, n_out):
    """The kernel's two taps a row hold exactly the matrix's entries, the
    clamped edges included (both taps on one index)."""
    from unpaired_image_captioning_tpu.ops.image import _interp_matrix

    m = io._interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(m, _interp_matrix(n_in, n_out))
    idx, wt = io.taps(n_in, n_out)
    rebuilt = np.zeros_like(m)
    for o in range(n_out):
        rebuilt[o, idx[o, 0]] += wt[o, 0]
        rebuilt[o, idx[o, 1]] += wt[o, 1]
    np.testing.assert_array_equal(rebuilt, m)
    if n_out > n_in:   # an upscale clamps its first row onto index 0
        assert idx[0, 0] == idx[0, 1] == 0 and wt[0].tolist() == [1.0, 0.0]


def test_cuda_tensor_is_not_sent_to_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version."""
    monkeypatch.setattr(ik, "resize_normalize_plain",
                        lambda *a, **k: pytest.fail("plain version called"))
    with pytest.raises(ValueError, match="unsupported device"):
        ik.resize_normalize(torch.zeros((1, 4, 4, 3), dtype=torch.uint8,
                                        device="meta"), h_out=2, w_out=2)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h_out,w_out", [
    ((16, 480, 640, 3), 448, 448), ((4, 375, 500, 3), 448, 448),
    ((2, 12, 10, 3), 29, 31), ((1, 14, 9, 1), 11, 13),
    ((2, 31, 45, 3), 17, 23), ((3, 37, 50, 3), 9, 22),
    ((3, 20, 30, 4), 15, 18), ((2, 19, 23, 1), 13, 17),
    ((1, 3, 40000, 3), 2, 39999)])
def test_cuda_kernel_matches_plain(cuda_dev, shape, h_out, w_out):
    imgs = torch.from_numpy(_imgs(shape, 3)).to(cuda_dev)
    n0 = ik.launches
    got = ik.resize_normalize(imgs, h_out=h_out, w_out=w_out)
    want = io.resize_normalize_plain(imgs, h_out=h_out, w_out=w_out)
    torch.cuda.synchronize()
    assert ik.launches == n0 + 1
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_identity_is_preprocess_images_bit_for_bit(cuda_dev):
    imgs = _imgs((4, 448, 448, 3), 5)
    got = ik.resize_normalize(torch.from_numpy(imgs).to(cuda_dev),
                              h_out=448, w_out=448)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  io.preprocess_images(imgs))


@pytest.mark.cuda
def test_cuda_identity_with_a_tail_is_preprocess_images_bit_for_bit(
        cuda_dev):
    """The identity at a width whose rows are not whole float4 (Wo * C =
    51) takes the general instance's head, body and tail: still the host's
    bits."""
    imgs = _imgs((3, 21, 17, 3), 6)
    got = ik.resize_normalize(torch.from_numpy(imgs).to(cuda_dev),
                              h_out=21, w_out=17)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  io.preprocess_images(imgs))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h_out,w_out", [
    ((16, 480, 640, 3), 448, 448), ((16, 448, 448, 3), 448, 448),
    ((2, 12, 10, 3), 29, 31), ((2, 31, 45, 3), 17, 23)])
def test_cuda_kernel_bf16_store_matches_plain(cuda_dev, shape, h_out, w_out):
    """The bf16 store (`out_dtype=torch.bfloat16`): the f32 value rounded to
    nearest even as it is stored, so at the identity size bit for bit the
    host's `to_bfloat16(preprocess_images)`, elsewhere within 1e-2 of the
    plain version; a bf16 launch."""
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)

    host = _imgs(shape, 3)
    imgs = torch.from_numpy(host).to(cuda_dev)
    n0 = ik.bf16_launches
    got = ik.resize_normalize(imgs, h_out=h_out, w_out=w_out,
                              out_dtype=torch.bfloat16)
    want = io.resize_normalize_plain(imgs, h_out=h_out, w_out=w_out,
                                     out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ik.bf16_launches == n0 + 1 and got.dtype == torch.bfloat16
    if shape[1:3] == (h_out, w_out):
        assert torch.equal(got.cpu().view(torch.int16),
                           to_bfloat16(io.preprocess_images(host))
                           .view(torch.int16))
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
