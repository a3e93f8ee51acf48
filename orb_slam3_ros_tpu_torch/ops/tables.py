"""Constant tables on the device, copied there once per (table, device).

A copy from host memory waits for the host and cannot be captured into a
CUDA graph, and the extractor reads its tables every frame. So each table is
made on the host and copied to a device at its first use (on the card, the
warm-up run before a capture) and read from there afterwards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_table(make, args: tuple, dtype: torch.dtype | None, device: torch.device) -> torch.Tensor:
    """``make(*args)`` (a module-level function returning an array) as a
    tensor of ``dtype`` (None: the array's) on ``device``, made once per
    distinct key. The tensor is shared: callers must not write into it."""
    t = torch.as_tensor(np.asarray(make(*args)))
    return t.to(device=device, dtype=dtype or t.dtype)
