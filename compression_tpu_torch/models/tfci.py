"""tfci: the command-line front end over trained codec checkpoints
(PyTorch counterpart of compression_tpu/models/tfci.py).

Models are resolved from a local registry directory (``--model_path``
root, one checkpoint directory per model name, as each model's ``train``
subcommand writes it: ``state.pt`` and ``config.json``).  ``decompress``
dispatches on the model identifier stored in the .tfci container, like the
reference (models/tfci.py:188-201): a container names its family
("bmshj2018"), so it is decoded with ``<root>/<family>`` whichever variant
wrote it.  ``compress --target_bpp`` (alias ``--rd_parameter``)
binary-searches the registered variants ``<family>-<quality>``, in name
order, for the largest rate within the target (reference
models/tfci.py:124-185).  The reference's frozen TensorFlow metagraphs are
not supported: a ``<model>.metagraph`` in the registry raises
NotImplementedError.  Every subcommand runs on the card unless
``--device cpu`` is given.

Subcommands: compress, decompress, models, tensors, dump.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from compression_tpu_torch.util import checkpoint as ckpt_lib
from compression_tpu_torch.util import datasets
from compression_tpu_torch.util.device import resolve_device
from compression_tpu_torch.util.packed_tensors import PackedTensors

__all__ = ["register_model", "compress", "decompress", "list_models",
           "list_tensors", "dump_tensor", "main"]

_BUILDERS = {}


def register_model(name):
    """Registers ``fn(config, params, device) -> codec`` for a family."""
    def wrap(fn):
        _BUILDERS[name] = fn
        return fn
    return wrap


def _loaded(module, config, params):
    model = module.model_from_config(config)
    model.load_state_dict(params)
    return model


@register_model("bls2017")
def _build_bls2017(config, params, device):
    from compression_tpu_torch.models import bls2017
    return bls2017.BLS2017Codec(_loaded(bls2017, config, params),
                                device=device)


@register_model("bmshj2018")
def _build_bmshj2018(config, params, device):
    from compression_tpu_torch.models import bmshj2018
    return bmshj2018.BMSHJ2018Codec(_loaded(bmshj2018, config, params),
                                    device=device)


@register_model("ms2020")
def _build_ms2020(config, params, device):
    from compression_tpu_torch.models import ms2020
    return ms2020.MS2020Codec(_loaded(ms2020, config, params),
                              device=device)


@register_model("hific")
def _build_hific(config, params, device):
    from compression_tpu_torch.models import hific
    return hific.HiFiCCodec(_loaded(hific, config, params), device=device)


def _no_metagraph(root, model):
    """Raises on ``<root>/<model>.metagraph``: the reference's frozen
    TensorFlow graphs need TensorFlow, which the port does not use."""
    path = os.path.join(root, model + ".metagraph")
    if os.path.exists(path):
        raise NotImplementedError(
            f"{path} is a frozen TensorFlow metagraph; the PyTorch port "
            "loads only checkpoints written by a model's train command")


def _registry_models(root):
    """Checkpoint directories under the registry root, in name order."""
    if not os.path.isdir(root):
        return []
    return [name for name in sorted(os.listdir(root))
            if os.path.exists(os.path.join(root, name, "config.json"))]


def _load_codec(root, model_name, device):
    payload, config = ckpt_lib.load_checkpoint(os.path.join(root, model_name))
    config = config or {}
    base = config.get("model_name", model_name.split("-")[0])
    if base not in _BUILDERS:
        raise ValueError(
            f"Unknown model family '{base}'; known: {sorted(_BUILDERS)}")
    return _BUILDERS[base](config, payload["params"], device)


def compress(root, model_name, input_file, output_file, target_bpp=None,
             bpp_strict=False, device="cuda"):
    img = datasets.load_image(input_file)
    num_pixels = img.shape[0] * img.shape[1]
    _no_metagraph(root, model_name)
    if target_bpp is None:
        container = _load_codec(root, model_name, device).compress(img)
    else:
        # Binary search over the registered variants of this family,
        # <family>-<quality>, assumed to rise in rate with their names.
        variants = [m for m in _registry_models(root)
                    if m.split("-")[0] == model_name]
        if not variants:
            raise ValueError(f"No registered variants for {model_name}")
        lo, hi = 0, len(variants) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            container = _load_codec(root, variants[mid], device).compress(img)
            if len(container) * 8 / num_pixels <= target_bpp:
                best = container
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            if bpp_strict:
                raise ValueError(
                    f"Could not achieve target {target_bpp} bpp.")
            best = container
        container = best
    with open(output_file, "wb") as f:
        f.write(container)
    bpp = len(container) * 8 / num_pixels
    print(f"{output_file}: {len(container)} bytes, {bpp:.4f} bpp")


def decompress(root, input_file, output_file, device="cuda"):
    with open(input_file, "rb") as f:
        container = f.read()
    model = PackedTensors(container).model
    _no_metagraph(root, model)
    img = np.asarray(_load_codec(root, model, device).decompress(container))
    datasets.save_image(output_file, img)
    print(f"wrote {output_file}")


def list_models(root):
    print("Registered local models:")
    for m in _registry_models(root):
        print(" ", m)
    if os.path.isdir(root):
        for f in sorted(os.listdir(root)):
            if f.endswith(".metagraph"):
                print(" ", f[: -len(".metagraph")],
                      "(frozen metagraph: not supported)")
    print("Known model families:", ", ".join(sorted(_BUILDERS)))


def list_tensors(root, model_name):
    """Prints ``name dtype shape`` for each entry of the checkpoint's
    state_dict (the port's names; the JAX package prints its pytree
    paths, which the port does not have)."""
    payload, _ = ckpt_lib.load_checkpoint(os.path.join(root, model_name))
    for name, value in payload["params"].items():
        print(f"{name} {str(value.dtype).replace('torch.', '')} "
              f"{tuple(value.shape)}")


def dump_tensor(root, model_name, tensors, input_file, output_file,
                device="cuda"):
    """Writes the analysis latents of an image (y, and z where the model
    has a hyperprior) to an .npz file, only those named in ``tensors``
    when it is not empty."""
    codec = _load_codec(root, model_name, device)
    x = codec._upload(datasets.load_image(input_file))
    out = {}
    with torch.no_grad():
        if hasattr(codec, "_encode"):
            out["y"], out["z"] = (e.cpu().numpy()
                                  for e in codec._encode(x)[:2])
        else:
            out["y"] = codec._analysis(x).cpu().numpy()
    keep = {k: v for k, v in out.items() if not tensors or k in tensors}
    np.savez(output_file, **keep)
    print(f"wrote {output_file} with {sorted(keep)}")


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="tfci", description="Codec front end (PyTorch).")
    parser.add_argument("--model_path", default="models",
                        help="Local model registry directory.")
    parser.add_argument("--device", default="cuda")
    sub = parser.add_subparsers(dest="command", required=True)

    c = sub.add_parser("compress")
    c.add_argument("model")
    c.add_argument("input_file")
    c.add_argument("output_file", nargs="?")
    c.add_argument("--rd_parameter", "--target_bpp", dest="target_bpp",
                   type=float, default=None)
    c.add_argument("--bpp_strict", action="store_true")

    d = sub.add_parser("decompress")
    d.add_argument("input_file")
    d.add_argument("output_file", nargs="?")

    sub.add_parser("models")

    t = sub.add_parser("tensors")
    t.add_argument("model")

    du = sub.add_parser("dump")
    du.add_argument("model")
    du.add_argument("--tensor", action="append", dest="tensors", default=[])
    du.add_argument("input_file")
    du.add_argument("output_file", nargs="?")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "compress":
        out = args.output_file or args.input_file + ".tfci"
        compress(args.model_path, args.model, args.input_file, out,
                 args.target_bpp, args.bpp_strict, device=device)
    elif args.command == "decompress":
        out = args.output_file or args.input_file + ".png"
        decompress(args.model_path, args.input_file, out, device=device)
    elif args.command == "models":
        list_models(args.model_path)
    elif args.command == "tensors":
        list_tensors(args.model_path, args.model)
    elif args.command == "dump":
        out = args.output_file or args.input_file + ".npz"
        dump_tensor(args.model_path, args.model, args.tensors,
                    args.input_file, out, device=device)

if __name__ == "__main__":
    main()
