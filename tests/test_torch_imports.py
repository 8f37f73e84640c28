"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX
package: the machine with the card has no JAX."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "compression_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(
            os.path.join(ROOT, "compression_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


MODULES = [
    "codec/cuda_coder.py", "codec/host.py", "codec/legacy.py",
    "codec/reference.py",
    "codec/stream.py", "codec/tables.py", "codec/torch_coder.py",
    "datasets/y4m.py",
    "distributions/base.py", "distributions/deep_factorized.py",
    "distributions/helpers.py", "distributions/round_adapters.py",
    "distributions/uniform_noise.py",
    "entropy_models/continuous_base.py",
    "entropy_models/continuous_batched.py",
    "entropy_models/continuous_indexed.py", "entropy_models/laplace.py",
    "entropy_models/power_law.py", "entropy_models/universal.py",
    "examples/__init__.py", "examples/evaluate.py",
    "examples/pod_compress.py", "examples/train_synthetic.py",
    "layers/gdn.py", "layers/initializers.py", "layers/parameters.py",
    "layers/signal_conv.py", "layers/soft_round.py",
    "models/bls2017.py", "models/bmshj2018.py", "models/cli.py",
    "models/hific.py", "models/image_codec.py", "models/lpips.py",
    "models/lvac.py", "models/ms2020.py", "models/native_format.py",
    "models/tfci.py", "models/toy_sources.py",
    "ops/math_ops.py", "ops/padding_ops.py", "ops/quantization.py",
    "ops/round_ops.py", "ops/run_length.py",
    "parallel/__init__.py", "parallel/multihost.py", "parallel/pipeline.py",
    "parallel/sharding.py", "util/checkpoint.py", "util/compile_cache.py",
    "util/datasets.py",
    "util/device.py", "util/kinks.py", "util/metrics.py",
    "util/packed_tensors.py", "util/philox.py", "util/profiling.py",
    "util/transfer.py", "util/xoshiro.py",
]

# The JAX package's modules whose counterparts carry other names.
COUNTERPARTS = {"codec/jax_coder.py": "codec/torch_coder.py",
                "codec/pallas_coder.py": "codec/cuda_coder.py"}


def test_port_has_modules():
    found = {os.path.relpath(p, os.path.join(ROOT, "compression_tpu_torch"))
             for p in _sources()}
    assert not set(MODULES) - found
    assert len(_sources()) >= 20


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_a_gpu(module):
    """Every module of the port imports on a machine with no GPU, no nvcc
    and no triton: kernels are built inside the call that launches them."""
    import importlib
    name = "compression_tpu_torch." + module[:-3].replace("/", ".")
    name = name.removesuffix(".__init__")
    assert importlib.import_module(name) is not None


def _jax_modules():
    base = os.path.join(ROOT, "compression_tpu")
    return sorted(
        os.path.relpath(os.path.join(dirpath, f), base)
        for dirpath, dirs, files in os.walk(base)
        if "__pycache__" not in dirpath for f in files if f.endswith(".py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_module_has_a_counterpart(module):
    """The port does all the JAX package does: each module of it has a
    module of the same path here, or the one COUNTERPARTS names."""
    mine = COUNTERPARTS.get(module, module)
    assert os.path.exists(os.path.join(ROOT, "compression_tpu_torch", mine))


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def _jax_top_level_names():
    """The names compression_tpu/__init__.py imports, read without
    importing it."""
    path = os.path.join(ROOT, "compression_tpu", "__init__.py")
    tree = ast.parse(open(path).read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)


@pytest.mark.parametrize("name", sorted(set(_jax_top_level_names())))
def test_top_level_names_mirror_jax(name):
    """Every top-level name of the JAX package has its counterpart here
    (its jax_coder is torch_coder)."""
    import compression_tpu_torch
    name = {"jax_coder": "torch_coder"}.get(name, name)
    assert name in compression_tpu_torch.__all__
    assert getattr(compression_tpu_torch, name) is not None


def test_package_import_loads_no_coder_module():
    """``import compression_tpu_torch`` imports its names on first use:
    nothing of the coder, its kernels or CUDA is loaded."""
    import subprocess
    import sys
    code = ("import sys, compression_tpu_torch as p; "
            "assert p.__version__; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('compression_tpu_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
