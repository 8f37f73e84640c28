"""The port's command line -- ``models/tfci.py``, ``models/cli.py`` and the
``main`` of bls2017, bmshj2018 and ms2020 -- against the JAX package's, on
the CPU (``--device cpu``), at tiny widths.

Each package writes its own registry from the same weights (JAX's
``cli.run train --steps 0`` initializes and saves them; the port's registry
holds them through ``params_from_jax``).  Each package's ``tfci compress``
container equals the other's and decodes in the other package's ``tfci
decompress`` to its own ``reconstruct`` (the image rounded from its own
synthesis); the two packages' pixels agree within one level, the width a
float rounding boundary gives (ROADMAP §3).  The ``--target_bpp`` search
picks the variant JAX's does; ``models`` / ``tensors`` / ``dump`` run;
``bls2017.main train`` takes two steps and its checkpoint compresses;
compress and decompress in two processes round-trip (each builds the
tables from the weights); ms2020 and HiFiC round-trip through the port's
``tfci``; a ``.metagraph`` raises NotImplementedError; without ``--device
cpu`` the command line raises when CUDA is absent.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from compression_tpu.models import cli as jax_cli
from compression_tpu.models import tfci as jax_tfci
from compression_tpu.util import checkpoint as jax_ckpt
from compression_tpu_torch.models import bls2017, bmshj2018, hific, ms2020
from compression_tpu_torch.models import tfci
from compression_tpu_torch.util import checkpoint
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"bls2017": bls2017, "bmshj2018": bmshj2018}
TINY_FLAGS = {"bls2017": ["--num_filters", "8"],
              "bmshj2018": ["--num_filters", "8"]}
# bmshj2018 variants: the last analysis layer scaled, so that the rate
# rises with the variant's name.
VARIANT_SCALES = {"bmshj2018-1": 0.5, "bmshj2018-2": 2.0,
                  "bmshj2018-3": 8.0}


def _jax_train(name, path, extra=()):
    """JAX's ``cli.run train`` with no step: the init, saved by orbax."""
    from compression_tpu.models import bls2017 as jb
    from compression_tpu.models import bmshj2018 as jh
    module = {"bls2017": jb, "bmshj2018": jh}[name]
    module.main(["train", "--model_path", path, "--steps", "0",
                 "--patchsize", "64", *TINY_FLAGS[name], *extra])


def _scaled(params, factor):
    """The flax params with bmshj2018's last analysis layer scaled."""
    params = {k: v for k, v in params.items()}
    tree = dict(params["params"])
    analysis = dict(tree["analysis"])
    layer = dict(analysis["layer_3"])
    layer["kernel_rdft"] = np.asarray(layer["kernel_rdft"]) * factor
    analysis["layer_3"] = layer
    tree["analysis"] = analysis
    params["params"] = tree
    return params


def _port_copy(jax_path, port_path, params=None):
    """The port's checkpoint of a JAX one: the same weights and config."""
    payload, config = jax_ckpt.load_checkpoint(jax_path)
    module = FAMILIES[config["model_name"]]
    checkpoint.save_checkpoint(
        port_path, module.params_from_jax(params or payload["params"]),
        config=config)


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    """(JAX registry, port registry, image path): bls2017 and bmshj2018 in
    each; and (JAX root, port root) of the three bmshj2018 variants."""
    base = tmp_path_factory.mktemp("tfci")
    jroot, proot = str(base / "jax"), str(base / "port")
    for name in FAMILIES:
        _jax_train(name, os.path.join(jroot, name))
        _port_copy(os.path.join(jroot, name), os.path.join(proot, name))
    payload, config = jax_ckpt.load_checkpoint(
        os.path.join(jroot, "bmshj2018"))
    jvar, pvar = str(base / "jax_variants"), str(base / "port_variants")
    for variant, factor in VARIANT_SCALES.items():
        params = _scaled(payload["params"], factor)
        jax_ckpt.save_checkpoint(os.path.join(jvar, variant), params,
                                 config=config)
        _port_copy(os.path.join(jvar, variant), os.path.join(pvar, variant),
                   params)
    img = str(base / "img.npy")
    np.save(img, np.random.RandomState(3).randint(
        0, 256, (64, 80, 3)).astype(np.uint8))
    return jroot, proot, img, (jvar, pvar)


def _port_codec(root, name):
    return tfci._load_codec(root, name, torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_containers_cross_decode(registries, name, tmp_path):
    """Both packages write the same container; each decodes the other's
    to what its own decompress gives, its ``reconstruct``; the pixels of
    the two packages are within one level."""
    jroot, proot, img, _ = registries
    jc, pc = str(tmp_path / "j.tfci"), str(tmp_path / "p.tfci")
    jax_tfci.compress(jroot, name, img, jc)
    tfci.main(["--model_path", proot, "--device", "cpu", "compress", name,
               img, pc])
    container = open(pc, "rb").read()
    assert open(jc, "rb").read() == container
    assert PackedTensors(container).model == name
    jout, pout = str(tmp_path / "j.npy"), str(tmp_path / "p.npy")
    jax_tfci.decompress(jroot, pc, jout)
    tfci.main(["--model_path", proot, "--device", "cpu", "decompress", jc,
               pout])
    x = np.load(img)
    mine = np.load(pout)
    np.testing.assert_array_equal(mine, _port_codec(proot, name)
                                  .reconstruct(x))
    theirs = np.load(jout)
    assert mine.shape == theirs.shape == x.shape
    assert np.abs(mine.astype(int) - theirs.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def variant_containers(registries):
    """Each variant's container of the image, from the port's codec."""
    _, _, img, (_, pvar) = registries
    x = np.load(img)
    return [_port_codec(pvar, v).compress(x) for v in sorted(VARIANT_SCALES)]


@pytest.mark.parametrize("target", ["mid", "high", "none"])
def test_target_bpp_picks_jax_variant(registries, variant_containers,
                                      target, tmp_path):
    """The binary search over bmshj2018-1..3 picks the variant JAX's picks
    and the one the rule names: the largest rate within the target, or
    the lowest variant when none fits (an error with --bpp_strict)."""
    _, _, img, (jvar, pvar) = registries
    pixels = np.load(img)[..., 0].size
    rates = [len(c) * 8 / pixels for c in variant_containers]
    assert rates == sorted(rates) and len(set(rates)) == 3
    bpp = {"mid": (rates[1] + rates[2]) / 2, "high": rates[2] + 1.0,
           "none": rates[0] / 2}[target]
    mine, theirs = str(tmp_path / "p.tfci"), str(tmp_path / "j.tfci")
    tfci.main(["--model_path", pvar, "--device", "cpu", "compress",
               "--target_bpp", str(bpp), "bmshj2018", img, mine])
    jax_tfci.compress(jvar, "bmshj2018", img, theirs, bpp)
    mine = open(mine, "rb").read()
    assert mine == open(theirs, "rb").read()
    expect = {"mid": 1, "high": 2, "none": 0}[target]
    assert mine == variant_containers[expect]
    if target == "none":
        with pytest.raises(ValueError, match="Could not achieve"):
            tfci.compress(pvar, "bmshj2018", img, str(tmp_path / "s"),
                          bpp, bpp_strict=True, device=torch.device("cpu"))


def test_variant_container_names_its_family(registries, tmp_path):
    """As in the JAX package, a variant's container names the family
    ("bmshj2018"), so decompress reads it with ``<root>/bmshj2018``."""
    _, _, img, (_, pvar) = registries
    out = str(tmp_path / "v.tfci")
    tfci.compress(pvar, "bmshj2018-3", img, out, device=torch.device("cpu"))
    assert PackedTensors(open(out, "rb").read()).model == "bmshj2018"
    with pytest.raises(FileNotFoundError):
        tfci.decompress(pvar, out, str(tmp_path / "v.npy"),
                        device=torch.device("cpu"))


def test_models_tensors_dump(registries, tmp_path, capsys):
    jroot, proot, img, _ = registries
    tfci.main(["--model_path", proot, "--device", "cpu", "models"])
    listed = capsys.readouterr().out
    for name in ("bls2017", "bmshj2018"):
        assert f"  {name}\n" in listed
    assert "Known model families: bls2017, bmshj2018, hific, ms2020" in listed
    tfci.main(["--model_path", proot, "--device", "cpu", "tensors",
               "bls2017"])
    lines = capsys.readouterr().out.strip().splitlines()
    state = checkpoint.load_checkpoint(os.path.join(proot, "bls2017"))[0]
    assert lines == [f"{k} float32 {tuple(v.shape)}"
                     for k, v in state["params"].items()]
    for name in ("bls2017", "bmshj2018"):
        out = str(tmp_path / f"{name}.npz")
        tfci.main(["--model_path", proot, "--device", "cpu", "dump", name,
                   img, out])
        mine = dict(np.load(out))
        ref = str(tmp_path / f"{name}_jax.npz")
        jax_tfci.dump_tensor(jroot, name, [], img, ref)
        ref = dict(np.load(ref))
        assert sorted(mine) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-4)
    out = str(tmp_path / "y_only.npz")
    tfci.main(["--model_path", proot, "--device", "cpu", "dump",
               "--tensor", "y", "bmshj2018", img, out])
    assert sorted(np.load(out).files) == ["y"]


def test_train_two_steps_then_compress(tmp_path, capsys):
    """``bls2017.main train`` (cli.run) takes two steps with a finite
    loss, saves the state_dict and config, and ``compress`` on that
    checkpoint writes the loaded codec's container; ``decompress`` its
    reconstruct."""
    ckpt = str(tmp_path / "bls2017")
    bls2017.main(["train", "--model_path", ckpt, "--steps", "2",
                  "--batchsize", "1", "--patchsize", "32",
                  "--num_filters", "8", "--device", "cpu"])
    logged = capsys.readouterr().out
    assert "step 0: loss=" in logged
    loss = float(logged.split("loss=")[1].split()[0])
    assert np.isfinite(loss)
    payload, config = checkpoint.load_checkpoint(ckpt)
    assert config == {"lmbda": 0.01, "num_filters": 8,
                      "model_name": "bls2017"}
    img = str(tmp_path / "img.npy")
    x = np.random.RandomState(4).randint(0, 256, (48, 40, 3)).astype(
        np.uint8)
    np.save(img, x)
    bls2017.main(["compress", "--model_path", ckpt, "--device", "cpu", img])
    bls2017.main(["decompress", "--model_path", ckpt, "--device", "cpu",
                  img + ".tfci", str(tmp_path / "out.npy")])
    model = bls2017.model_from_config(config)
    model.load_state_dict(payload["params"])
    codec = bls2017.BLS2017Codec(model, device="cpu")
    assert open(img + ".tfci", "rb").read() == codec.compress(x)
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")),
                                  codec.reconstruct(x))


def test_two_processes_round_trip(registries, tmp_path):
    """compress and decompress in separate processes, each building the
    tables from the checkpoint's weights, give the reconstruction."""
    _, proot, img, _ = registries
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = str(tmp_path / "c.tfci")
    for argv in (["compress", "bmshj2018", img, out],
                 ["decompress", out, str(tmp_path / "d.npy")]):
        subprocess.run(
            [sys.executable, "-m", "compression_tpu_torch.models.tfci",
             "--model_path", proot, "--device", "cpu", *argv],
            check=True, env=env, cwd=str(tmp_path), timeout=300)
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "d.npy")),
        _port_codec(proot, "bmshj2018").reconstruct(np.load(img)))


TINY_MS2020 = dict(num_filters=8, latent_depth=8, hyperprior_depth=4,
                   num_slices=4, max_support_slices=2, num_scales=8,
                   scale_max=32.0)
TINY_HIFIC = hific.HiFiCConfig(num_down=2, num_filters_base=4,
                               num_filters_bottleneck=8,
                               num_residual_blocks=1, hyper_filters=4)


@pytest.mark.parametrize("family", ["ms2020", "hific"])
def test_port_round_trip(family, tmp_path, monkeypatch):
    """ms2020 (the JAX tests' tiny widths) and HiFiC (a tiny registered
    config) through the port's tfci: the container is the loaded codec's
    compress, the decompressed image its reconstruct."""
    root = str(tmp_path / "reg")
    if family == "ms2020":
        config = dict(ms2020.CLI_DEFAULTS, **TINY_MS2020,
                      model_name="ms2020")
        model = ms2020.model_from_config(config, seed=1)
    else:
        monkeypatch.setitem(hific._CONFIGS, "tiny", TINY_HIFIC)
        config = {"model_name": "hific", "config": "tiny", "target": 0.2}
        model = hific.model_from_config(config, seed=1)
    checkpoint.save_checkpoint(os.path.join(root, family),
                               model.state_dict(), config=config)
    img = str(tmp_path / "img.npy")
    x = np.random.RandomState(5).randint(0, 256, (64, 48, 3)).astype(
        np.uint8)
    np.save(img, x)
    tfci.main(["--model_path", root, "--device", "cpu", "compress", family,
               img])
    tfci.main(["--model_path", root, "--device", "cpu", "decompress",
               img + ".tfci", str(tmp_path / "out.npy")])
    codec = _port_codec(root, family)
    assert open(img + ".tfci", "rb").read() == codec.compress(x)
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")),
                                  codec.reconstruct(x))


def test_metagraph_raises(registries, tmp_path):
    _, proot, img, _ = registries
    root = str(tmp_path / "reg")
    os.makedirs(root)
    with open(os.path.join(root, "hific-lo.metagraph"), "wb") as f:
        f.write(b"\x00")
    with pytest.raises(NotImplementedError, match="metagraph"):
        tfci.main(["--model_path", root, "--device", "cpu", "compress",
                   "hific-lo", img, str(tmp_path / "x.tfci")])
    container = PackedTensors()
    container.model = "hific-lo"
    container.pack([np.zeros(1, np.int32)])
    with open(str(tmp_path / "mg.tfci"), "wb") as f:
        f.write(container.string)
    with pytest.raises(NotImplementedError, match="metagraph"):
        tfci.main(["--model_path", root, "--device", "cpu", "decompress",
                   str(tmp_path / "mg.tfci"), str(tmp_path / "x.npy")])


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works")


@pytest.mark.parametrize("argv", [
    ["models"], ["compress", "bls2017", "img.npy"],
    ["decompress", "img.npy.tfci"]])
def test_default_device_needs_cuda(no_cuda, argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfci.main(argv)


@pytest.mark.parametrize("module", [bls2017, bmshj2018, ms2020])
def test_model_main_default_device_needs_cuda(no_cuda, module, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["train", "--model_path", str(tmp_path / "c"),
                     "--steps", "1"])


def test_cli_defaults_equal_jax():
    """The model mains' flags and defaults are the JAX package's."""
    from compression_tpu.models import bls2017 as jb
    from compression_tpu.models import bmshj2018 as jh
    from compression_tpu.models import ms2020 as jm
    seen = {}

    def grab(name, defaults, *_args, **_kw):
        seen[name] = dict(defaults)

    for module in (jb, jh, jm):
        orig = jax_cli.run
        jax_cli.run = grab
        try:
            module.main([])
        finally:
            jax_cli.run = orig
    assert seen == {"bls2017": bls2017.CLI_DEFAULTS,
                    "bmshj2018": bmshj2018.CLI_DEFAULTS,
                    "ms2020": ms2020.CLI_DEFAULTS}
    for name, module in (("bls2017", bls2017), ("bmshj2018", bmshj2018),
                         ("ms2020", ms2020)):
        assert json.loads(json.dumps(module.CLI_DEFAULTS)) == seen[name]
