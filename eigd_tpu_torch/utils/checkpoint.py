"""Checkpoint and warm restart of optimisation state.

Counterpart of ``eigd_tpu/utils/checkpoint.py``. JAX's saves with orbax
and falls back to an npz file; the port has one format, ``torch.save`` of
a dict of tensors, read back with ``torch.load(weights_only=True)`` (no
pickled code runs on load).
"""

from __future__ import annotations

import torch


def save_checkpoint(path, state: dict):
    """Write ``state``, a dict of tensors (e.g. x, lam, Q), to ``path``.
    Returns the format's name."""
    torch.save({k: torch.as_tensor(v).detach().cpu() for k, v in
                state.items()}, path)
    return "torch"


def load_checkpoint(path, like: dict = None):
    """The dict written by ``save_checkpoint``. With ``like`` (a dict of
    tensors), each entry of ``like`` comes back on its tensor's device and
    dtype; a missing key or another shape raises."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if like is None:
        return state
    out = {}
    for k, v in like.items():
        if state[k].shape != v.shape:
            raise ValueError(f"checkpoint entry {k!r} has shape "
                             f"{tuple(state[k].shape)}, expected "
                             f"{tuple(v.shape)}")
        out[k] = state[k].to(device=v.device, dtype=v.dtype)
    return out
