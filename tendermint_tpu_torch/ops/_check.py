"""Argument checks and constants shared by the kernel wrappers."""

from __future__ import annotations

import numpy as np
import torch

_consts: dict = {}


def tensors(device: torch.device, **named) -> None:
    """Raise ValueError unless every (tensor, dtype, shape) lies on the
    CUDA `device`, has that dtype and shape, and is contiguous."""
    if device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {device}")
    for name, (t, dtype, shape) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def device_const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host constant copied to `device` once and cached."""
    key = (id(arr), str(device))
    t = _consts.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
        _consts[key] = t
    return t


def launched(name: str, rc: int) -> None:
    """Raise if the launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
