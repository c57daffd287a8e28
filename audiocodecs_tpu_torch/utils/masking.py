"""Length and mask helpers on tensors.

Counterpart of ``audiocodecs_tpu/utils/masking.py``: variable lengths are
carried as (padded tensor, relative-length vector) pairs, and padding to a
multiple or to one of a few bucket lengths keeps the number of distinct
shapes small. Tensors stay on the caller's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["length_mask", "pad_to_bucket", "pad_to_multiple",
           "relative_to_absolute"]


def relative_to_absolute(length: torch.Tensor, total: int) -> torch.Tensor:
    """Relative lengths in [0, 1] → absolute sample counts (int32, rounded
    half to even)."""
    return torch.round(length * total).to(torch.int32)


def length_mask(length: torch.Tensor, total: int,
                dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """``[B]`` relative lengths → ``[B, total]`` validity mask
    (``arange(total) < length * total``)."""
    abs_lens = length * total
    idx = torch.arange(total, dtype=torch.float32, device=length.device)[None]
    return (idx < abs_lens[:, None]).to(dtype)


def _pad_axis(x: torch.Tensor, axis: int, extra: int, value) -> torch.Tensor:
    axis = axis % x.ndim
    return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, extra], value=value)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = -1,
                    value=0.0):
    """Pad ``x`` along ``axis`` up to the next multiple of ``multiple``;
    returns ``(padded, original size)``."""
    size = x.shape[axis]
    target = int(math.ceil(size / multiple) * multiple)
    if target == size:
        return x, size
    return _pad_axis(x, axis, target - size, value), size


def pad_to_bucket(x: torch.Tensor, buckets: tuple[int, ...], axis: int = -1,
                  value=0.0):
    """Pad ``x`` along ``axis`` to the smallest bucket ≥ its size; returns
    ``(padded, original size)``. Raises if no bucket is large enough."""
    size = x.shape[axis]
    for b in sorted(buckets):
        if b >= size:
            target = b
            break
    else:
        raise ValueError(f"no bucket >= {size} in {buckets}")
    if target == size:
        return x, size
    return _pad_axis(x, axis, target - size, value), size
