"""Checkpoints of model weights and entropy-model tables (PyTorch
counterpart of compression_tpu/util/checkpoint.py).

The serialization invariant of the reference (continuous_base.py:176-184):
range-coding tables are SAVED, never rebuilt, since independent rebuilds
on sender and receiver can diverge in float math and corrupt range
decoding.  So a checkpoint bundles a model's state_dict with the frozen
tables of its entropy models as they are given, and loading returns them
as they were saved.  A checkpoint is a directory holding ``state.pt``
(``torch.save`` of ``{"params": state_dict, "em": {name: [arrays]}}``)
and, when given, ``config.json``.  The JAX package's orbax checkpoints are
not read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, state_dict, em_weights: Optional[dict] = None,
                    config: Optional[dict] = None):
    """Saves a state_dict (+ optional entropy-model tables and model
    config) to the directory ``path``.

    Args:
      path: checkpoint directory (created if missing).
      state_dict: the model's ``state_dict()``; saved on the CPU.
      em_weights: dict name -> list of arrays (an entropy model's
        ``get_weights()``), saved as CPU tensors.
      config: JSON-serializable model / entropy-model configuration.
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {"params": {k: torch.as_tensor(v).detach().cpu()
                          for k, v in state_dict.items()}}
    if em_weights:
        payload["em"] = {
            name: [torch.as_tensor(np.asarray(w)) for w in weights]
            for name, weights in em_weights.items()}
    torch.save(payload, os.path.join(path, "state.pt"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)


def load_checkpoint(path: str):
    """Loads a checkpoint saved by save_checkpoint onto the CPU.

    Returns (payload dict with "params" and optional "em", config dict or
    None); raises FileNotFoundError when ``path`` holds no checkpoint.
    """
    path = os.path.abspath(path)
    state = os.path.join(path, "state.pt")
    if not os.path.exists(state):
        raise FileNotFoundError(f"No checkpoint found at {path}")
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    payload = torch.load(state, map_location="cpu", weights_only=True)
    return payload, config
