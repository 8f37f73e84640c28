"""HiFiC's command line on the port (``hific.main``) with its checkpoint and
dataset modules (util/checkpoint.py, util/datasets.py), on the CPU
(``--device cpu``).

The checkpoint round trip (state_dict, carried entropy-model tables that
code the same containers as the tables they were saved from, config); the
dataset module against the JAX package's (the same noise batches and
crops from a directory or a glob of .npy images, the same errors); the
command line's train (a tiny configuration registered as
tests/test_lvac_hific_train.py registers it, with the GAN), warm start,
target override, and compress / decompress of a .npy image: the container
is the codec's ``compress`` from the checkpoint, the decompressed image
its ``reconstruct``.  Everything here is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from compression_tpu.util import datasets as jax_datasets
from compression_tpu_torch.models import hific
from compression_tpu_torch.util import checkpoint, datasets

torch.set_num_threads(1)

TINY = hific.HiFiCConfig(num_down=2, num_filters_base=4,
                         num_filters_bottleneck=8, num_residual_blocks=1,
                         hyper_filters=4)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setitem(hific._CONFIGS, "tiny", TINY)
    return "tiny"


# -- checkpoint -------------------------------------------------------------
def test_checkpoint_round_trip(tmp_path):
    """The state_dict, the entropy-model tables as saved (not rebuilt: a
    codec on them writes the containers of the codec they came from) and
    the config come back; a missing checkpoint raises."""
    model = hific.HiFiCModel(TINY, seed=3)
    codec = hific.HiFiCCodec(model, device="cpu")
    tables = {"y": codec.em.get_weights(), "z": codec.side_em.get_weights()}
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, model.state_dict(), em_weights=tables,
                               config={"config": "tiny", "target": 0.2})
    payload, config = checkpoint.load_checkpoint(path)
    assert config == {"config": "tiny", "target": 0.2}
    assert set(payload) == {"params", "em"}
    for k, v in model.state_dict().items():
        assert torch.equal(payload["params"][k], v)
    for name, weights in tables.items():
        assert len(payload["em"][name]) == len(weights)
        for got, want in zip(payload["em"][name], weights):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    loaded = hific.HiFiCModel(TINY, seed=0)
    loaded.load_state_dict(payload["params"])
    carried = hific.HiFiCCodec(loaded, device="cpu", tables=(
        payload["em"]["y"], payload["em"]["z"]))
    x = np.random.RandomState(0).randint(0, 256, (48, 40, 3)).astype(
        np.uint8)
    assert carried.compress(x) == codec.compress(x)
    assert carried.compress_native(x) == codec.compress_native(x)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"))


def test_checkpoint_without_tables_or_config(tmp_path):
    path = str(tmp_path / "bare")
    checkpoint.save_checkpoint(path, {"w": torch.arange(3.0)})
    payload, config = checkpoint.load_checkpoint(path)
    assert config is None and set(payload) == {"params"}
    assert torch.equal(payload["params"]["w"], torch.arange(3.0))


# -- datasets ---------------------------------------------------------------
def test_noise_batches_equal_jax():
    mine = datasets.image_patch_iterator(None, 2, 16, seed=4)
    ref = jax_datasets.image_patch_iterator(None, 2, 16, seed=4)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.dtype == np.float32 and a.shape == (2, 16, 16, 3)
        np.testing.assert_array_equal(a, b)


@pytest.fixture()
def image_dir(tmp_path):
    """Four .npy images: two large enough for 32-pixel crops, one too
    small, one grey (2-D)."""
    rng = np.random.RandomState(5)
    d = tmp_path / "images"
    d.mkdir()
    for name, shape in (("a.npy", (40, 48, 3)), ("b.npy", (33, 64, 3)),
                        ("small.npy", (16, 16, 3)), ("grey.npy", (36, 36))):
        np.save(str(d / name), rng.randint(0, 256, shape).astype(np.uint8))
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("pattern", ["dir", "glob"])
def test_crops_equal_jax(image_dir, pattern):
    where = image_dir if pattern == "dir" else os.path.join(image_dir,
                                                            "*.npy")
    mine = datasets.image_patch_iterator(where, 3, 32, seed=6)
    ref = jax_datasets.image_patch_iterator(where, 3, 32, seed=6)
    for _ in range(4):
        np.testing.assert_array_equal(next(mine), next(ref))


def test_load_and_save_npy(image_dir, tmp_path):
    grey = datasets.load_image(os.path.join(image_dir, "grey.npy"))
    assert grey.shape == (36, 36, 3) and grey.dtype == np.uint8
    np.testing.assert_array_equal(
        grey, jax_datasets.load_image(os.path.join(image_dir, "grey.npy")))
    out = str(tmp_path / "out.npy")
    datasets.save_image(out, grey)
    np.testing.assert_array_equal(datasets.load_image(out), grey)


def test_dataset_errors(image_dir, tmp_path):
    with pytest.raises(ValueError, match="No images"):
        next(datasets.image_patch_iterator(str(tmp_path), 1, 8))
    with pytest.raises(ValueError, match="at least"):
        next(datasets.image_patch_iterator(image_dir, 1, 128))


# -- the command line -------------------------------------------------------
def _image(path, shape=(64, 48, 3), seed=7):
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    np.save(path, img)
    return img


def test_train_compress_decompress(tiny, tmp_path, capsys):
    """train (2 GAN steps at batch 1 of 32x32) saves the generator; the
    compress container is the codec's from that checkpoint, classic (5
    tensors); decompress writes its reconstruct."""
    ckpt = str(tmp_path / "ckpt")
    hific.main(["train", "--config", tiny, "--model_path", ckpt,
                "--num_steps", "2", "--batchsize", "1", "--patchsize", "32",
                "--device", "cpu"])
    payload, config = checkpoint.load_checkpoint(ckpt)
    assert config == {"model_name": "hific", "config": "tiny",
                      "target": TINY.target}
    model = hific.HiFiCModel(TINY)
    model.load_state_dict(payload["params"])
    assert any(not torch.equal(v, hific.HiFiCModel(TINY).state_dict()[k])
               for k, v in payload["params"].items())
    codec = hific.HiFiCCodec(model, device="cpu")
    src = str(tmp_path / "img.npy")
    img = _image(src)
    hific.main(["compress", "--model_path", ckpt, "--device", "cpu", src])
    with open(src + ".tfci", "rb") as f:
        container = f.read()
    assert container == codec.compress(img)
    out = str(tmp_path / "back.npy")
    hific.main(["decompress", "--model_path", ckpt, "--device", "cpu",
                src + ".tfci", out])
    np.testing.assert_array_equal(np.load(out), codec.reconstruct(img))
    assert "bpp" in capsys.readouterr().out


def test_warm_start_and_target(tiny, tmp_path, image_dir):
    """--warm_start with no steps saves the checkpoint it started from;
    --target and --train_glob reach the config and the batches."""
    first = str(tmp_path / "first")
    hific.main(["train", "--config", tiny, "--model_path", first,
                "--num_steps", "1", "--batchsize", "1", "--patchsize", "32",
                "--train_glob", image_dir, "--target", "0.3",
                "--device", "cpu"])
    again = str(tmp_path / "again")
    hific.main(["train", "--config", tiny, "--model_path", again,
                "--num_steps", "0", "--warm_start", first,
                "--device", "cpu"])
    a, _ = checkpoint.load_checkpoint(first)
    b, config = checkpoint.load_checkpoint(again)
    assert all(torch.equal(a["params"][k], v)
               for k, v in b["params"].items())
    with open(os.path.join(first, "config.json")) as f:
        assert json.load(f)["target"] == 0.3
    assert config["target"] == TINY.target


def test_main_defaults_to_the_card(tiny, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, hific.HiFiCModel(TINY).state_dict(),
                               config={"config": "tiny"})
    src = str(tmp_path / "img.npy")
    _image(src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hific.main(["compress", "--model_path", ckpt, src])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hific.main(["train", "--config", tiny, "--model_path", ckpt,
                    "--num_steps", "1"])
