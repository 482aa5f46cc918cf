"""Constants that live on the device.

Under ``jax.jit`` a numpy array is a compile-time constant. Eager PyTorch would copy it
from the host on every call, which makes the step wait for the stream. So each constant
is built and copied once per device, and handed out from a cache afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def cached(key, device, build) -> torch.Tensor:
    """The tensor of ``build()`` (a numpy array) on ``device``; built once per
    ``(key, device)``."""
    k = (key, str(device))
    if k not in _CACHE:
        _CACHE[k] = torch.from_numpy(np.ascontiguousarray(build())).to(device)
    return _CACHE[k]


def on_device(a: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant on ``device`` (keyed by the array's identity)."""
    return cached(("array", id(a)), device, lambda: a)
