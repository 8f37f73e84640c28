"""Shared argparse command line for the codecs (train / compress /
decompress), the PyTorch counterpart of compression_tpu/models/cli.py.

Mirrors the reference model scripts' subcommand structure
(models/bls2017.py:326-451): ``train`` fits a model and writes a
checkpoint (``util/checkpoint.py``: the state_dict and ``config.json``),
``compress`` writes the model's classic .tfci container, ``decompress``
reconstructs the image.  As in the JAX package, the entropy models' tables
are not saved: compress and decompress each build them from the loaded
weights, on the CPU with the native quantizer, so both sides get the same
tables.  Every subcommand runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np
import torch

from compression_tpu_torch.util import checkpoint as ckpt_lib
from compression_tpu_torch.util import datasets
from compression_tpu_torch.util.device import resolve_device

__all__ = ["make_parser", "run"]


def make_parser(model_name, defaults):
    parser = argparse.ArgumentParser(
        prog=model_name,
        description=f"{model_name} codec (train/compress/decompress)")
    sub = parser.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="Train the model.")
    t.add_argument("--model_path", default=f"{model_name}_ckpt")
    # Every model hyperparameter becomes a flag and is kept in the
    # checkpoint's config, so that compress / decompress rebuild the same
    # architecture.
    for key, val in defaults.items():
        flag = "--lambda" if key == "lmbda" else f"--{key}"
        if isinstance(val, bool):
            t.add_argument(flag, dest=key,
                           action="store_false" if val else "store_true")
        else:
            t.add_argument(flag, dest=key, type=type(val), default=val)
    t.add_argument("--train_glob", default=None,
                   help="Directory of training images (png/jpg/npy). "
                        "Default: synthetic noise (smoke run).")
    t.add_argument("--batchsize", type=int, default=8)
    t.add_argument("--patchsize", type=int, default=256)
    t.add_argument("--steps", type=int, default=10000)
    t.add_argument("--learning_rate", type=float, default=1e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda")

    c = sub.add_parser("compress", help="Compress an image to a .tfci file.")
    c.add_argument("--model_path", default=f"{model_name}_ckpt")
    c.add_argument("--device", default="cuda")
    c.add_argument("input_file")
    c.add_argument("output_file", nargs="?")

    d = sub.add_parser("decompress", help="Decompress a .tfci file.")
    d.add_argument("--model_path", default=f"{model_name}_ckpt")
    d.add_argument("--device", default="cuda")
    d.add_argument("input_file")
    d.add_argument("output_file", nargs="?")
    return parser


def run(model_name, defaults, build_model, build_codec, argv=None):
    """Generic command-line driver.

    Args:
      model_name: e.g. "bls2017".
      defaults: dict of default hyperparameters (the flags of ``train``).
      build_model: (config dict, seed) -> torch module with seeded weights.
      build_codec: (model, device=) -> codec with compress(img) -> bytes
        and decompress(bytes) -> img.
      argv: the arguments (None: sys.argv).
    """
    args = make_parser(model_name, defaults).parse_args(argv)
    device = resolve_device(args.device)

    if args.command == "train":
        model = build_model(vars(args), args.seed).to(device)
        optimizer = torch.optim.Adam(model.parameters(),
                                     lr=args.learning_rate)
        mod = importlib.import_module(type(model).__module__)
        step_fn = mod.make_train_step(model, optimizer)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        data = datasets.image_patch_iterator(
            args.train_glob, args.batchsize, args.patchsize, args.seed)
        for step, batch in zip(range(args.steps), data):
            metrics = step_fn(batch, generator=generator)
            if step % 100 == 0:
                print(f"step {step}: " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()),
                    flush=True)
        config = {k: getattr(args, k) for k in defaults}
        config["model_name"] = model_name
        ckpt_lib.save_checkpoint(args.model_path, model.state_dict(),
                                 config=config)
        print(f"saved checkpoint to {args.model_path}")
        return

    payload, config = ckpt_lib.load_checkpoint(args.model_path)
    model = build_model(config or defaults, 0)
    model.load_state_dict(payload["params"])
    codec = build_codec(model, device=device)

    if args.command == "compress":
        img = datasets.load_image(args.input_file)
        container = codec.compress(img)
        out = args.output_file or args.input_file + ".tfci"
        with open(out, "wb") as f:
            f.write(container)
        bpp = len(container) * 8 / (img.shape[0] * img.shape[1])
        print(f"{out}: {len(container)} bytes, {bpp:.4f} bpp")
    elif args.command == "decompress":
        with open(args.input_file, "rb") as f:
            container = f.read()
        img = np.asarray(codec.decompress(container))
        out = args.output_file or args.input_file + ".png"
        datasets.save_image(out, img)
        print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")
