"""Explicit device resolution.

Every public function of the port takes a `device`; nothing picks one
globally.  The CLI reads DASHING_TPU_TORCH_DEVICE (default "cuda").  A
request for CUDA on a machine without a usable card raises: the port never
carries on on the CPU behind the caller's back.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

ENV_VAR = "DASHING_TPU_TORCH_DEVICE"


def resolve(device: Union[str, torch.device]) -> torch.device:
    """Validate a device request; raise if it cannot be honoured."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                f"is False; set {ENV_VAR}=cpu to run on the CPU on purpose")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(device)!r} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device type {dev.type!r} "
                           "(expected 'cuda' or 'cpu')")
    return dev


def from_env() -> torch.device:
    """The CLI's device: DASHING_TPU_TORCH_DEVICE, default 'cuda'.  On a
    card it also states the matmul policy: full float32, TF32 off, which
    the exact register-count matmuls of ops/pairwise.py need."""
    dev = resolve(os.environ.get(ENV_VAR, "cuda") or "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def or_env(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`device` validated, or the CLI's device when it is None."""
    return from_env() if device is None else resolve(device)
