"""Shares a training step's decisions at the kinks between two devices.

A value within float32 error of a kink -- a relu's or a leaky relu's
``x > 0``, a max-pool's choice, a rounding -- may fall on either side of it
on the card and on the CPU, and one such element moves a kernel's gradient
by ~1e-3 of its largest magnitude.  A parity check of a step runs it on the
card with ``SharedKinks`` recording each decision, then on the CPU with the
same decisions replayed in the same order, so that what is left to compare
is the arithmetic.  ``flips`` counts the decisions the CPU would have taken
otherwise, by kind (a max-pool's only where the values differ).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["SharedKinks"]


class SharedKinks:
    """Stands in for ``torch.nn.functional`` in a model's modules and for
    ``round_ops.round_st`` while a step runs (``sharing``).  With
    ``replay`` None it records each decision (a relu's and a leaky relu's
    mask x > 0, a max-pool's indices, a rounding's values); with ``replay``
    set to the recorded list it replays them (a relu as x * mask, a leaky
    relu as x * where(mask, 1, slope), a max-pool as a gather of the
    recorded choice, a rounding as the recorded values with the identity
    gradient).  Every other attribute is ``torch.nn.functional``'s."""

    def __init__(self):
        self.functional = F
        self.round_st_fn = None
        self.masks = []
        self.replay = None
        self.flips = {"relu": 0, "leaky_relu": 0, "max_pool2d": 0,
                      "round": 0}

    def __getattr__(self, name):
        return getattr(self.functional, name)

    @contextlib.contextmanager
    def sharing(self, *modules, round_ops=None):
        """Sets each module's ``F`` to this object and, when ``round_ops``
        is given, its ``round_st`` to ``self.round_st``; restores both on
        exit, whatever happens inside."""
        saved = [(m, m.F) for m in modules]
        if round_ops is not None:
            self.round_st_fn = round_ops.round_st
        try:
            for m in modules:
                m.F = self
            if round_ops is not None:
                round_ops.round_st = self.round_st
            yield self
        finally:
            for m, functional in saved:
                m.F = functional
            if round_ops is not None:
                round_ops.round_st = self.round_st_fn

    def _take(self, kind, x, own):
        """Records ``own`` when recording; when replaying returns the
        recorded decision and counts where ``own`` differs."""
        if self.replay is None:
            self.masks.append(own.detach())
            return None
        recorded = self.replay.pop(0).to(x.device)
        self.flips[kind] += int((recorded != own).sum())
        return recorded

    def relu(self, x):
        mask = self._take("relu", x, x > 0)
        return self.functional.relu(x) if mask is None else x * mask

    def leaky_relu(self, x, negative_slope=0.01):
        mask = self._take("leaky_relu", x, x > 0)
        if mask is None:
            return self.functional.leaky_relu(x, negative_slope)
        return x * torch.where(mask, 1.0, negative_slope)

    def max_pool2d(self, x, kernel_size, stride=None):
        out, idx = self.functional.max_pool2d(x, kernel_size, stride,
                                              return_indices=True)
        if self.replay is None:
            self.masks.append(idx)
            return out
        recorded = self.replay.pop(0).to(x.device)
        chosen = x.flatten(2).gather(2, recorded.flatten(2)).view_as(out)
        self.flips["max_pool2d"] += int((chosen != out).sum())
        # In the layout max_pool2d gives (channels last from NHWC images):
        # the next convolution's arithmetic follows it.
        if not out.is_contiguous():
            chosen = chosen.contiguous(memory_format=torch.channels_last)
        return chosen

    def round_st(self, inputs, offset=None):
        shift = inputs if offset is None else inputs - offset
        rounded = self._take("round", inputs, shift.detach().round())
        if rounded is None:
            return self.round_st_fn(inputs, offset)
        # The recorded rounded value with the identity gradient to inputs.
        if offset is not None:
            rounded = rounded + offset.detach()
        return rounded + (inputs - inputs.detach())
