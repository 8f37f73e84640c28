"""The port's example scripts (compression_tpu_torch/examples) on the CPU at
a small size, against the JAX package where they compute the same thing.

* train_synthetic: the texture source equals the JAX script's for the same
  seed and size, bit for bit (both are numpy); ``main`` at 8 filters, 32 px
  and 3 steps prints its RD summary and the verdict line and returns 0 or 1
  (three steps decide nothing about the trade-off).
* evaluate: over a registry that bls2017's ``train`` writes (8 filters,
  no step) and three seeded images, the rows' MS-SSIM equals JAX's
  ``util.metrics`` on the same image pairs within 1e-5 relative (float32
  sums in two orders); the PSNR equals the float64 value of its formula
  within 1e-5 relative and JAX's within 1e-4: the untrained codec's pairs
  sit near 5 dB, where JAX's float32 mean of the 1e5 squared errors is
  itself 1.4e-5 (relative) off the float64 value on a.npy; the bpp equals
  8 * len(compress(img)) / pixels exactly, and an image below 176 pixels a
  side gets NaN for MS-SSIM, from the port's ``ImageTooSmallError``
  alone.
* pod_compress: an in-process CPU mesh of 2 (1 image, 8 channels) codes
  byte-identical streams at 1 and 2 devices, decodes them to ``quantize``,
  and writes its record only where ``--out`` says.
* Without CUDA each script raises unless ``--device cpu`` is given.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from compression_tpu.util import metrics as jax_metrics
from compression_tpu_torch.examples import evaluate, pod_compress
from compression_tpu_torch.examples import train_synthetic
from compression_tpu_torch.models import bls2017, tfci
from compression_tpu_torch.util import metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples import train_synthetic as jax_train_synthetic  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("patchsize,seed,n", [(32, 0, 2), (48, 3, 1)])
def test_texture_source_equals_jax(patchsize, seed, n):
    mine = train_synthetic.make_texture_source(patchsize, seed=seed)
    ref = jax_train_synthetic.make_texture_source(patchsize, seed=seed)
    for _ in range(2):
        np.testing.assert_array_equal(mine(n), ref(n))
    it = train_synthetic.batch_iter(
        train_synthetic.make_texture_source(patchsize, seed=seed), n)
    np.testing.assert_array_equal(
        next(it), jax_train_synthetic.make_texture_source(
            patchsize, seed=seed)(n))


def test_train_synthetic_prints_rd_summary(capsys):
    rc = train_synthetic.main([
        "--steps", "3", "--num_filters", "8", "--patchsize", "32",
        "--batch_size", "2", "--eval_images", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "RD summary" in out
    assert out.count("held-out textures") == 2
    verdict = "OK" if rc == 0 else "VIOLATED"
    assert f"monotone RD tradeoff: {verdict}" in out


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A bls2017 checkpoint written by its own train command (8 filters,
    no step), and three seeded images as .npy: two of 176 pixels a side or
    more, one of 64x80 (too small for MS-SSIM's five scales)."""
    root = tmp_path_factory.mktemp("registry")
    bls2017.main(["train", "--model_path", str(root / "bls2017"),
                  "--steps", "0", "--num_filters", "8", "--device", "cpu"])
    images = root / "images"
    images.mkdir()
    rng = np.random.RandomState(5)
    for name, shape in (("a.npy", (176, 192, 3)), ("b.npy", (64, 80, 3)),
                        ("c.npy", (184, 176, 3))):
        base = rng.randint(0, 256, (shape[0] // 8, shape[1] // 8, 3))
        img = np.kron(base, np.ones((8, 8, 1))) + rng.randint(-9, 10, shape)
        np.save(images / name, np.clip(img, 0, 255).astype(np.uint8))
    return root, images


def test_evaluate_rows_match_jax_metrics(registry, tmp_path, capsys):
    root, images = registry
    out = tmp_path / "rd.csv"
    rows = evaluate.main(["--model_path", str(root), "--model", "bls2017",
                          "--images", str(images), "--out", str(out),
                          "--device", "cpu"])
    text = capsys.readouterr().out
    assert [r[0] for r in rows] == ["a.npy", "b.npy", "c.npy"]
    assert "aggregate (3 images)" in text
    codec = tfci._load_codec(str(root), "bls2017", torch.device("cpu"))
    for name, bpp, psnr, msssim in rows:
        img = np.load(images / name)
        container = codec.compress(img)
        assert bpp == 8 * len(container) / (img.shape[0] * img.shape[1])
        a = img.astype(np.float32)
        b = codec.decompress(container).astype(np.float32)
        mse = np.mean((a.astype(np.float64) - b) ** 2)
        np.testing.assert_allclose(psnr, 10 * np.log10(255 ** 2 / mse),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            psnr, float(jax_metrics.psnr(a, b)), rtol=1e-4)
        if min(img.shape[:2]) < 176:
            assert math.isnan(msssim)
        else:
            np.testing.assert_allclose(
                msssim, float(jax_metrics.msssim(a[None], b[None])[0]),
                rtol=1e-5)
    lines = out.read_text().splitlines()
    assert lines[0] == "image,bpp,psnr,msssim" and len(lines) == 4
    assert lines[2].startswith("b.npy,") and lines[2].endswith(",nan")


@pytest.mark.parametrize("side,raises", [(175, True), (176, False)])
def test_msssim_too_small_error(side, raises):
    """The one error evaluate turns into NaN: a scale below the window."""
    a = np.random.RandomState(side).rand(1, side, side, 3) * 255
    if raises:
        with pytest.raises(metrics.ImageTooSmallError):
            metrics.msssim(a, a * 0.9, device="cpu")
    else:
        assert math.isfinite(float(metrics.msssim(a, a * 0.9,
                                                  device="cpu")))


def test_pod_compress_cpu_mesh(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pod_compress, "NUM_IMAGES", 1)
    monkeypatch.setattr(pod_compress, "CHANNELS", 8)
    args = ["--device", "cpu", "--num_devices", "2"]
    assert pod_compress.main(args) == 0
    text = capsys.readouterr().out
    assert "devices: 2 x cpu" in text
    assert "1 device(s): encode" in text and "2 device(s): encode" in text
    assert "container bytes identical across device counts: True" in text
    assert os.listdir(tmp_path) == []
    out = tmp_path / "record.json"
    assert pod_compress.main(args + ["--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["bytes_deterministic_across_device_counts"] is True
    assert record["devices"] == 2 and record["virtual_mesh"] is True
    assert set(record["phase_decomposition_ms"]) == {"1", "2"}


@pytest.mark.parametrize("run", [
    lambda: train_synthetic.main(["--steps", "1"]),
    lambda: evaluate.main(["--model", "bls2017", "--images", "."]),
    lambda: pod_compress.main([])], ids=["train_synthetic", "evaluate",
                                         "pod_compress"])
def test_examples_need_cuda_or_device_cpu(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
