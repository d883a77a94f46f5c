"""Device introspection and health checks.

Counterpart of ``nbody_streams_tpu/utils/devices.py`` (the reference's
``get_gpu_info`` and ``cuda_alive``), from ``torch.cuda``.
"""
from __future__ import annotations

import platform

import torch

from .._device import resolve_device

__all__ = ["get_device_info", "device_alive"]


def get_device_info(device="cuda") -> dict:
    """Platform, device kind, memory in use and its limit, device count.

    ``device`` is the card by default (without one it raises, naming
    ``device='cpu'``); ``device='cpu'`` describes the host."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"platform": "cpu",
                "device_kind": platform.processor() or platform.machine(),
                "id": 0, "n_devices": 1, "process_index": 0,
                "default_backend": "cpu"}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(index)
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(index),
            "id": index,
            "n_devices": torch.cuda.device_count(),
            "process_index": 0,
            "default_backend": "cuda",
            "bytes_in_use": total - free,
            "bytes_limit": total}


def device_alive(device="cuda") -> bool:
    """Cheap end-to-end health check: run one op on ``device`` and read it
    back.  False when it fails, a missing card included."""
    try:
        x = torch.arange(8.0, device=device)
        return abs(float(x.sum().item()) - 28.0) < 1e-6
    except Exception:
        return False
