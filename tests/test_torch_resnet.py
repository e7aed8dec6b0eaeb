"""The port's raw-image feature path against the JAX package's, on the CPU:
`ResNet.my_resnet` (resnet_tiny) on bridged weights at 1e-4 * max(1,
max|jax|) (f32 convolutions summed in another order), with XLA's SAME
padding at even and odd sizes and the att grid resized up and down;
`convert_torchvision_state_dict` on a generated state dict against JAX's
conversion plus the bridge (exact); `RawImageLoader.get_batch` against
JAX's on one folder of .npy images (shapes, values at the same tolerance,
`infos`, `wrapped`); `prepro_feats.main` writing its files.
"""

import json

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.models import resnet as tr

TOL = 1e-4


def _torchvision_state(depth, seed):
    """A torchvision-layout ResNet state dict of random numbers (conv
    weights He-scaled, BatchNorm statistics away from the identity)."""
    r = np.random.RandomState(seed)
    state = {}

    def conv(name, cout, cin, k):
        state[name] = (r.randn(cout, cin, k, k)
                       * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    def bn(name, c):
        state[name + ".weight"] = r.uniform(0.5, 1.5, c).astype(np.float32)
        state[name + ".bias"] = (r.randn(c) * 0.1).astype(np.float32)
        state[name + ".running_mean"] = (r.randn(c) * 0.1).astype(np.float32)
        state[name + ".running_var"] = r.uniform(0.5, 2.0, c).astype(
            np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, n_blocks in enumerate(tr.BLOCKS[depth]):
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


@pytest.fixture(scope="module")
def weights():
    from unpaired_image_captioning_tpu.models.resnet import (
        convert_torchvision_state_dict as jax_convert)

    state = _torchvision_state("resnet_tiny", 0)
    return state, jax_convert(state, "resnet_tiny")


def _close(got, want):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def test_convert_equals_jax_conversion_plus_bridge(weights):
    state, jax_tree = weights
    ours = tr.convert_torchvision_state_dict(state, "resnet_tiny")
    bridged = bridge.resnet_state_from_jax(jax_tree)
    assert ours.keys() == bridged.keys()
    for k in ours:
        assert torch.equal(ours[k], bridged[k]), k
    model = tr.ResNet("resnet_tiny", device="cpu")
    assert model.state_dict().keys() == ours.keys()
    model.load_state_dict(ours)


@pytest.mark.parametrize("size,att_size", [
    (64, 2),    # 2x2 map: att is the map itself
    (64, 5),    # 2x2 -> 5x5: upscale
    (71, 2),    # odd input (SAME pads (3, 3) in the stem, (1, 1) in the
                # pool), 3x3 map -> 2x2: antialiased downscale
    (71, 4),    # 3x3 -> 4x4: upscale
], ids=["64-identity", "64-up", "71-down", "71-up"])
def test_my_resnet_matches_jax(weights, size, att_size):
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models.resnet import ResNet

    _, jax_tree = weights
    img = np.random.RandomState(size).randn(2, size, size, 3).astype(
        np.float32)
    jfc, jatt = ResNet("resnet_tiny").my_resnet(jax_tree, jnp.asarray(img),
                                                att_size=att_size)
    model = tr.ResNet("resnet_tiny", device="cpu")
    model.load_state_dict(bridge.resnet_state_from_jax(jax_tree))
    with torch.no_grad():
        fc, att = model.my_resnet(torch.from_numpy(img), att_size=att_size)
    assert tuple(att.shape) == (2, att_size, att_size, 2048)
    _close(fc.numpy(), jfc)
    _close(att.numpy(), jatt)


@pytest.mark.parametrize("n,k,s,pads", [(448, 7, 2, (2, 3)),
                                        (112, 3, 2, (0, 1)),
                                        (56, 3, 1, (1, 1)), (65, 7, 2, (3, 3)),
                                        (56, 1, 2, (0, 0))])
def test_same_pads_are_xla_s(n, k, s, pads):
    assert tr._same_pads(n, k, s) == pads


def _image_folder(tmp_path, sizes):
    r = np.random.RandomState(0)
    for i, (h, w) in enumerate(sizes):
        img = r.randint(0, 256, (h, w, 3) if i % 3 else (h, w)).astype(
            np.uint8)
        np.save(tmp_path / f"img{i:02d}.npy", img)
    return str(tmp_path)


def test_raw_image_loader_matches_jax(weights, tmp_path, monkeypatch):
    from unpaired_image_captioning_tpu.data.raw_images import (
        RawImageLoader as JaxLoader)

    from unpaired_image_captioning_tpu_torch.data import raw_images
    from unpaired_image_captioning_tpu_torch.data.raw_images import (
        RawImageLoader)

    front_end = raw_images.resize_normalize

    def contiguous_upload(x, **kw):   # the card's kernel takes no other
        assert x.dtype == torch.uint8 and x.is_contiguous()
        return front_end(x, **kw)

    monkeypatch.setattr(raw_images, "resize_normalize", contiguous_upload)
    _, jax_tree = weights
    folder = _image_folder(tmp_path, [(30, 40), (48, 36), (64, 64)])
    kw = dict(folder_path=folder, batch_size=2, att_size=2,
              depth="resnet_tiny", image_size=64)
    jl = JaxLoader(resnet_params=jax_tree, **kw)
    tl = RawImageLoader(resnet_params=bridge.resnet_state_from_jax(jax_tree),
                        device="cpu", **kw)
    for _ in range(2):   # the second batch wraps around
        jb, tb = jl.get_batch(), tl.get_batch()
        assert tb["bounds"] == jb["bounds"]
        assert tb["infos"] == jb["infos"]
        for key in ("fc_feats", "att_feats", "attri_feats", "att_masks",
                    "labels", "masks"):
            assert tuple(tb[key].shape) == jb[key].shape, key
            assert tb[key].is_contiguous(), key
            _close(tb[key].numpy(), jb[key])
    assert tb["bounds"]["wrapped"]


def test_prepro_feats_writes_features(tmp_path):
    from unpaired_image_captioning_tpu_torch.data.raw_images import (
        RawImageLoader)
    from unpaired_image_captioning_tpu_torch.scripts import prepro_feats

    folder = _image_folder(tmp_path, [(40, 30), (20, 24), (33, 33)])
    images = [{"id": 10 + i, "file_path": f"{folder}/img{i:02d}.npy"}
              for i in range(3)]
    listing = tmp_path / "images.json"
    listing.write_text(json.dumps({"images": images}))
    out = tmp_path / "feats"
    prepro_feats.main(["--input_json", str(listing), "--output_dir", str(out),
                       "--model", "resnet_tiny", "--batch_size", "2",
                       "--device", "cpu"])
    loader = RawImageLoader(coco_json=str(listing), batch_size=3,
                            depth="resnet_tiny", device="cpu")
    batch = loader.get_batch()
    for i, info in enumerate(images):
        fc = np.load(tmp_path / "feats_fc" / f"{info['id']}.npy")
        att = np.load(tmp_path / "feats_att" / f"{info['id']}.npz")["feat"]
        assert fc.shape == (2048,) and att.shape == (14, 14, 2048)
        np.testing.assert_array_equal(fc, batch["fc_feats"][i].numpy())
        np.testing.assert_array_equal(
            att, batch["att_feats"][i].numpy().reshape(14, 14, 2048))
