"""The training media callback of the port (maavss_tpu_torch/exp/viz.py,
train/setup.make_fusion_media_fn, tools/fit_torch.py under MAAVSS_MEDIA=1)
against the JAX package's (maavss_tpu/exp/viz.py, matplotlib), on the CPU.

- Each image function gives JAX's array bit for bit.
- `save_image` writes, without matplotlib, the pixels of the JAX
  package's `save_image` (matplotlib's `imsave`) for magma and viridis:
  the two PNGs decode to equal RGBA arrays, over unit images, constant
  images, NaNs, integer and float64 arrays; `png_pixels` reads the port's
  file back to the same array.
- `reconstruction_callback` writes JAX's media set: equal PNG pixels and
  equal wav bytes.
- The fusion media function writes its STFT panel (pixel for pixel the
  panel of its separated clip) and its two wavs of the clip's length.
- The port's media path imports no matplotlib, jax or maavss_tpu (a
  subprocess).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from maavss_tpu.exp import viz as jax_viz
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data.wavio import read_wav
from maavss_tpu_torch.exp import viz
from maavss_tpu_torch.ops.stft import stft_features
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_fusion, make_fusion_media_fn
from tests.test_torch_workers import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_frames=4, num_seq=2, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "filmstrip": ((rng.random((20, 16, 16)) * 255).astype(np.uint8),),
        "stft_pair_image": (rng.standard_normal((2, 16, 33)),
                            rng.standard_normal((2, 16, 33)).astype(
                                np.float32)),
        "phasegram_image": (rng.standard_normal((1, 8, 256)),
                            rng.standard_normal((1, 8, 256))),
        "latent_grid": (rng.standard_normal(100).astype(np.float32),),
    }


@pytest.mark.parametrize("name", ["filmstrip", "stft_pair_image",
                                  "phasegram_image", "latent_grid"])
def test_image_functions_equal_jax(name):
    args = _inputs()[name]
    got, want = getattr(viz, name)(*args), getattr(jax_viz, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


@pytest.mark.parametrize("cmap", ["magma", "viridis"])
def test_save_image_equals_matplotlib(tmp_path, cmap):
    rng = np.random.default_rng(1)
    nan = rng.random((12, 7)).astype(np.float32)
    nan[3, 4] = np.nan
    images = [rng.random((20, 33)).astype(np.float32),
              rng.standard_normal((7, 9)),
              np.zeros((4, 5), np.float32), nan,
              (rng.random((6, 6)) * 255).astype(np.uint8),
              rng.integers(-5, 5, (5, 8)),
              viz.stft_pair_image(*_inputs()["stft_pair_image"]),
              viz.filmstrip(_inputs()["filmstrip"][0])]
    for i, img in enumerate(images):
        mine = viz.save_image(str(tmp_path / f"port{i}.png"), img, cmap)
        ref = jax_viz.save_image(str(tmp_path / f"jax{i}.png"), img, cmap)
        got, want = _pixels(mine), _pixels(ref)
        assert got.shape == want.shape == img.shape + (4,), i
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        np.testing.assert_array_equal(viz.png_pixels(mine), got)


def test_reconstruction_callback_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    y, yh = (rng.standard_normal((2, 16, 33)).astype(np.float32)
             for _ in range(2))
    pg, pgh = (rng.standard_normal((1, 8, 64)) for _ in range(2))
    frames = (rng.random((6, 16, 16)) * 255).astype(np.uint8)

    def audio_fn(s):
        return s[0].ravel()[:400] * 0.1

    kw = dict(audio_fn=audio_fn, y_pgram=pg, yh_pgram=pgh, frames=frames)
    mine = viz.reconstruction_callback(str(tmp_path / "port"), 7, y, yh, **kw)
    ref = jax_viz.reconstruction_callback(str(tmp_path / "jax"), 7, y, yh,
                                          **kw)
    assert [os.path.basename(p) for p in mine] == \
        [os.path.basename(p) for p in ref] and len(mine) == 5
    for a, b in zip(mine, ref):
        if a.endswith(".png"):
            np.testing.assert_array_equal(_pixels(a), _pixels(b))
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), a


def test_fusion_media_fn_writes_its_files(tmp_path):
    """One call of the fusion media function on a CPU model: the STFT
    panel of the batch's first clip and its separated audio (the same
    separator, the same noise draw), and both wavs at the clip's length."""
    cfg = RunConfig(**SMALL)
    model = build_fusion(cfg, 1, "cpu")
    samples = cfg.hop * cfg.hops_per_frame * (cfg.num_frames + cfg.num_seq)
    rng = np.random.default_rng(3)
    batch = {"audio": rng.standard_normal((2, samples)).astype(np.float32),
             "frames": rng.random((2, cfg.num_frames + cfg.num_seq, 16, 16))
             .astype(np.float32)}
    media = make_fusion_media_fn(model, cfg, str(tmp_path / "media"))
    media(None, batch, torch.Generator().manual_seed(4), 12)
    names = sorted(os.listdir(tmp_path / "media"))
    assert names == ["audio_in_0000012.wav", "audio_out_0000012.wav",
                     "stft_0000012.png"]
    one = {k: torch.from_numpy(v[:1]) for k, v in batch.items()}
    out = make_separator(model, cfg)(one, torch.Generator().manual_seed(4))

    def feats(a):
        return stft_features(a, cfg.fft_len, cfg.hop)[0].numpy()

    want = viz.to_rgba(viz.stft_pair_image(feats(one["audio"]),
                                           feats(out["audio_out"])))
    got = viz.png_pixels(str(tmp_path / "media" / "stft_0000012.png"))
    np.testing.assert_array_equal(got, want)
    for name in ("audio_in", "audio_out"):
        wav, sr = read_wav(str(tmp_path / "media" / f"{name}_0000012.wav"))
        assert sr == cfg.samplerate and wav.size == samples, name


def test_media_path_imports_no_matplotlib(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "from maavss_tpu_torch.exp import viz\n"
        "import maavss_tpu_torch.train.setup\n"
        "from tools import fit_torch\n"
        f"viz.save_image({str(tmp_path / 'a.png')!r}, np.eye(4), 'viridis')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'jax', 'maavss_tpu', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr
