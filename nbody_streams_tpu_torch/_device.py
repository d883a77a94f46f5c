"""The default-device rule of the package's entry points.

Solvers, loaders and the state carried across from the JAX package build
on the card unless the caller asks for the CPU; without a card the default
raises and names the CPU option.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device, indexed: bool = False) -> torch.device:
    """The device an entry point builds on: ``'cuda'`` (every entry point's
    default) raises without a card, so the CPU is used only when the
    caller asks for it with ``device='cpu'``.  ``indexed`` fills in the
    current card's index of a bare ``'cuda'``, so that devices compare."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but torch sees no CUDA "
                           "device; pass device='cpu' to build on the CPU")
    if indexed and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
