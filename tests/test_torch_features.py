"""Offline feature extraction of the port against the JAX package on the
CPU (maavss_tpu_torch/ops/dino.py, ops/flow.py, ops/image.py,
convert.dino_from_flax, tools/save_attn_videos_torch.py,
tools/flow_torch.py).

Same numpy inputs on both sides, one JAX compile per shape.

- DINO: a tiny ViT (dim 32, 4 heads, depth 3, patch 4, grid 4) on a
  26x22 input (neither a multiple of the patch nor the native grid): the
  last block's attention, the CLS feature, the attention maps and the
  threshold masks within 1e-5 (the masks equal, on JAX's attention and on
  one with ties); the full ViT-S/8 in the port alone against
  tests/fixtures/dino_golden.npz (attention rtol 1e-4, features rtol 1e-3,
  as tests/test_dino_golden.py holds the JAX package); the bicubic
  position-embedding matrix against DINO's own F.interpolate call; a
  strict load of an official-format checkpoint; VideoAttention's crop.
  The position embedding is held within 1e-5 of its largest value: the
  matrix form rounds apart from F.interpolate's taps by ~2e-6.
- image: each function against JAX; the nearest resize exactly; the crop
  on the rectangle JAX's sampler draws, within 1e-5 (values in [0, 1]: one
  ulp of a sample coordinate near 56 moves a bilinear weight by 4e-6).
- flow: a moving blob and random frames, windows 15 and 4: the raw flow
  within 1e-5 of the largest flow at the pixels where det exceeds 100
  eps^2 (where det is near eps^2 it cancels, and a flow there is
  rounding; the flows measured here agree there too, to 2e-6), the
  magnitude within 1e-5 relative L2 over each clip.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maavss_tpu.ops import dino as j_dino
from maavss_tpu.ops import flow as j_flow
from maavss_tpu.ops import image as j_image
from maavss_tpu_torch.convert import dino_from_flax
from maavss_tpu_torch.data.frame_shards import FrameShardStore, write_frame_shard
from maavss_tpu_torch.data.synthetic import moving_blob_frames
from maavss_tpu_torch.ops import dino, flow, image
from tests.test_torch_workers import share_cores
from tools import flow_torch, save_attn_videos_torch

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "dino_golden.npz")
DIM, HEADS, DEPTH, PATCH, GRID = 32, 4, 3, 4, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


# ---- DINO ----

@pytest.fixture(scope="module")
def tiny_vit():
    sd = dino.seeded_state_dict(0, embed_dim=DIM, depth=DEPTH,
                                patch_size=PATCH, pos_grid=GRID, scale=0.05)
    params = j_dino.convert_torch_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, depth=DEPTH)
    jm = j_dino.VisionTransformer(patch_size=PATCH, embed_dim=DIM,
                                  depth=DEPTH, num_heads=HEADS, pos_grid=GRID)
    x = np.random.default_rng(1).standard_normal((3, 3, 26, 22)).astype(
        np.float32)

    @jax.jit
    def run(params, x):
        return (jm.apply({"params": params}, x,
                         method=jm.get_last_selfattention),
                jm.apply({"params": params}, x))

    attn, feats = (np.asarray(a) for a in run(params, x))
    model = dino.VisionTransformer(PATCH, DIM, DEPTH, HEADS, GRID)
    model.load_state_dict(sd, strict=True)
    return sd, params, model.eval(), x, attn, feats


def test_dino_from_flax_gives_back_the_official_tree(tiny_vit):
    sd, params = tiny_vit[:2]
    got = dino_from_flax(params)
    assert set(got) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_tiny_vit_matches_jax(tiny_vit):
    _, _, model, x, attn, feats = tiny_vit
    with torch.no_grad():
        got_attn = model.get_last_selfattention(_t(x))
        got_feats = model(_t(x))
    assert tuple(got_attn.shape) == attn.shape == (3, HEADS, 31, 31)
    _close(got_attn.numpy(), attn, 1e-5, "attention")
    _close(got_feats.numpy(), feats, 1e-5, "CLS feature")
    maps_j = np.asarray(j_dino.cls_attention_maps(jnp.asarray(attn), 6, 5,
                                                  PATCH))
    maps_p = dino.cls_attention_maps(got_attn, 6, 5, PATCH).numpy()
    assert maps_p.shape == (3, 24, 20)
    _close(maps_p, maps_j, 1e-5, "maps")


@pytest.mark.parametrize("ties", [False, True])
def test_threshold_masks_match_jax(tiny_vit, ties):
    attn = tiny_vit[4]
    if ties:  # a few levels only: long runs of equal values
        attn = np.round(attn * 40) / 40 + 1e-3
    want = np.asarray(j_dino.threshold_masks(jnp.asarray(attn), 6, 5, PATCH,
                                             0.6))
    got = dino.threshold_masks(_t(attn), 6, 5, PATCH, 0.6).numpy()
    assert got.shape == (3, HEADS, 24, 20)
    np.testing.assert_array_equal(got, want)


def test_vit_s8_golden_in_the_port_alone():
    fix = np.load(GOLDEN)
    assert list(fix["meta"]) == [384, 6, 12, 8, 28]
    sd = dino.seeded_state_dict(20260819)
    probe = np.concatenate([v.numpy().ravel()[:16] for v in sd.values()])
    np.testing.assert_array_equal(probe, fix["weight_probe"])
    model = dino.VisionTransformer()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        attn = model.get_last_selfattention(_t(fix["x"]))
        feats = model(_t(fix["x"]))
    np.testing.assert_allclose(attn.numpy(), fix["attn"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(feats.numpy(), fix["feats"], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("hp,wp", [(8, 5), (32, 32), (6, 40)])
def test_bicubic_pos_embed_matches_dino_interpolate(hp, wp):
    model = dino.VisionTransformer(patch_size=8, embed_dim=16, depth=1,
                                   num_heads=2)
    with torch.no_grad():
        model.pos_embed.copy_(torch.randn(model.pos_embed.shape,
                                          generator=torch.Generator()
                                          .manual_seed(hp)))
        got = model._pos_embed_for(hp, wp)
        # dino/vision_transformer.py:interpolate_pos_encoding
        grid = model.pos_embed[:, 1:].reshape(1, 28, 28, 16).permute(0, 3, 1, 2)
        want = F.interpolate(grid, scale_factor=((hp + 0.1) / 28,
                                                 (wp + 0.1) / 28),
                             mode="bicubic")
    assert want.shape[-2:] == (hp, wp)
    want = want.permute(0, 2, 3, 1).reshape(1, hp * wp, 16)
    _close(got[:, 1:].numpy(), want.numpy(), 1e-5, "pos_embed")
    torch.testing.assert_close(got[:, :1], model.pos_embed[:, :1])


def test_official_checkpoint_loads_strictly(tmp_path):
    sd = dino.seeded_state_dict(3)
    path = str(tmp_path / "dino.pth")
    torch.save({"teacher": {f"module.backbone.{k}": v for k, v in sd.items()},
                "epoch": 1}, path)
    loaded = dino.load_torch_weights(path)
    assert set(loaded) == set(sd)
    va = dino.VideoAttention(loaded, device="cpu")
    for k, v in va.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        dino.VideoAttention({**loaded, "head.last_layer.weight":
                             torch.zeros(1)}, device="cpu")
    missing = dict(loaded)
    missing.pop("blocks.3.mlp.fc2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        dino.VideoAttention(missing, device="cpu")


def test_video_attention_crops_and_normalizes():
    va = dino.VideoAttention(dino.seeded_state_dict(4), device="cpu")
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 70, 67)).astype(np.float32))
    out = va(frames)
    assert tuple(out.shape) == (2, 1, 64, 64)
    with torch.no_grad():
        attn = va.model.get_last_selfattention(frames[..., :64, :64])
    torch.testing.assert_close(out[:, 0], dino.cls_attention_maps(
        attn, 8, 8, 8), rtol=0, atol=0)
    torch.testing.assert_close(out.amax(dim=(-2, -1)), torch.ones(2, 1))
    # a random frozen ViT from a seed: the same weights each time
    a, b = (dino.VideoAttention(architecture="vit_tiny", seed=1,
                                device="cpu").model.state_dict()
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---- image ----

def test_pixel_transforms_match_jax():
    x = np.random.default_rng(6).random((2, 3, 9, 7)).astype(np.float32)
    x[1, 2] = 0.25  # a flat channel: autocontrast leaves it
    for name in ("normalize_imagenet", "grayscale", "autocontrast"):
        want = np.asarray(getattr(j_image, name)(jnp.asarray(x)))
        got = getattr(image, name)(_t(x)).numpy()
        assert got.shape == want.shape, name
        _close(got, want, 1e-6, name)


@pytest.mark.parametrize("shape,size", [((2, 5, 7), (3, 4)),
                                        ((5, 7), (11, 13)),
                                        ((1, 2, 16, 16), (7, 9))])
def test_resize_nearest_is_jax_exactly(shape, size):
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    want = np.asarray(j_image.resize_nearest(jnp.asarray(x), size))
    np.testing.assert_array_equal(image.resize_nearest(_t(x), size).numpy(),
                                  want)


def test_resized_crop_on_jax_sampled_rectangles():
    clip = np.random.default_rng(8).random((2, 3, 40, 56)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        rect = [int(v) for v in j_image.sample_resized_crop(key, (40, 56))]
        want = np.asarray(j_image.random_resized_crop(key, jnp.asarray(clip),
                                                      24))
        got = image.resized_crop(_t(clip), *rect, 24).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sample_resized_crop_draws_in_bounds():
    g = torch.Generator().manual_seed(9)
    for _ in range(50):
        top, left, h, w = image.sample_resized_crop(g, (40, 56))
        assert 1 <= h <= 40 and 1 <= w <= 56
        assert 0 <= top <= 40 - h and 0 <= left <= 56 - w
    clip = torch.rand(3, 40, 56, generator=g)
    a = image.random_resized_crop(torch.Generator().manual_seed(2), clip, 16)
    b = image.random_resized_crop(torch.Generator().manual_seed(2), clip, 16)
    assert tuple(a.shape) == (3, 16, 16) and torch.equal(a, b)


# ---- flow ----

@pytest.fixture(scope="module")
def flow_frames():
    blob = moving_blob_frames(3, 1, 5, 32)[0]
    noise = np.random.default_rng(10).random((5, 32, 32)).astype(np.float32)
    return np.stack([blob, noise])  # [2 clips, T, H, W]


def _det(prev, window, eps=1e-4):
    """sxx * syy - sxy^2 of lucas_kanade_dense, from the port's convs."""
    sx = torch.tensor(flow.SCHARR_X) / 32.0
    ix, iy = flow._conv2d_same(prev, sx), flow._conv2d_same(prev, sx.T)
    box = torch.full((window, window), 1.0 / window ** 2)
    sxx = flow._conv2d_same(ix * ix, box) + eps
    syy = flow._conv2d_same(iy * iy, box) + eps
    sxy = flow._conv2d_same(ix * iy, box)
    return sxx * syy - sxy * sxy


@pytest.mark.parametrize("window", [15, 4])
def test_flow_matches_jax(flow_frames, window):
    want = np.asarray(j_flow.clip_flow(jnp.asarray(flow_frames),
                                       window=window))
    got = flow.clip_flow(_t(flow_frames), window=window).numpy()
    assert got.shape == want.shape == (2, 5, 2, 32, 32)
    det = _det(_t(flow_frames[:, :-1]), window).numpy()
    for c in range(2):
        well = np.broadcast_to((det[c] > 100 * 1e-8)[:, None],
                               got[c, 1:].shape)
        assert well.mean() > 0.1
        err = np.abs(got[c, 1:] - want[c, 1:])[well].max()
        assert err <= 1e-5 * np.abs(want[c, 1:][well]).max()
    np.testing.assert_array_equal(got[:, 0], 0.0)
    mag_j = np.asarray(j_flow.flow_magnitude(jnp.asarray(flow_frames),
                                             window=window))
    mag_p = flow.flow_magnitude(_t(flow_frames), window=window).numpy()
    for c in range(2):
        rel = np.linalg.norm(mag_p[c] - mag_j[c]) / np.linalg.norm(mag_j[c])
        assert rel <= 1e-5, (c, rel)


# ---- the tools ----

def _store(root, rgb=False):
    rng = np.random.default_rng(11)
    for v in range(2):
        shape = (6, 32, 32, 3) if rgb else (6, 32, 32)
        write_frame_shard(os.path.join(root, "frames"), f"vid{v}",
                          rng.integers(0, 256, shape, dtype=np.uint8), 30.0)
    return FrameShardStore(os.path.join(root, "frames"))


@pytest.mark.parametrize("autocontrast", [False, True])
def test_save_attn_videos_tool_on_cpu(tmp_path, autocontrast):
    """The tool end to end: each shard is the uint8 of VideoAttention's
    maps of the normalised (then autocontrasted) frames, with the store's
    fps."""
    store = _store(str(tmp_path))
    weights = str(tmp_path / "dino.pth")
    torch.save({"teacher": dino.seeded_state_dict(12)}, weights)
    out = save_attn_videos_torch.save_attention(
        str(tmp_path), weights=weights, chunk=4, autocontrast=autocontrast,
        device="cpu")
    attn = FrameShardStore(out)
    va = dino.VideoAttention(dino.seeded_state_dict(12), device="cpu")
    for v in range(2):
        fr = torch.from_numpy(store.read(v, np.arange(6))).float() / 255.0
        fr = image.normalize_imagenet(fr[:, None].expand(-1, 3, -1, -1))
        if autocontrast:
            fr = image.autocontrast(fr)
        want = (np.clip(va(fr)[:, 0].numpy(), 0, 1) * 255).astype(np.uint8)
        got = attn.read(v, np.arange(6))
        assert attn.fps(v) == 30.0 and got.dtype == np.uint8
        # chunks of 4 and 2 against one batch of 6: equal to a unit
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_flow_tool_on_cpu(tmp_path, monkeypatch):
    _store(str(tmp_path), rgb=True)
    v, mag = flow_torch.flow_frames(str(tmp_path), video=1, num_frames=4,
                                    rng=np.random.default_rng(0),
                                    device="cpu")
    assert v == 1 and mag.shape == (4, 32, 32) and mag.max() == 1.0
    monkeypatch.chdir(tmp_path)
    flow_torch.main(["--data_path", str(tmp_path), "--video", "0",
                     "--num_frames", "3", "--out", "pngs", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "pngs")) == [
        f"flow_{t:03d}.png" for t in range(3)]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib is not installed"):
        flow_torch.main(["--data_path", str(tmp_path), "--device", "cpu"])
