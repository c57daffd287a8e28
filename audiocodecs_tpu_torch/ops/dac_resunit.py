"""Fused DAC residual unit: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/dac_resunit.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/dac_resunit_pallas.py::dac_resunit_pallas``: one pass
over ``x`` per block of (batch, time tile) computes

    out = x + conv1(snake(conv7_d(snake(x, α1)) + b7, α2)) + b1

with zero padding of 3·d on both sides of the dilated k7 conv, so the output
has the input's length. The source's header states its bound and design.

Layout is PyTorch's ``[B, C, T]``. Weights are conv weights in PyTorch's
``[Cout, Cin, K]``: ``w7 [C, C, 7]``, ``w1 [C, C, 1]``; ``alpha1``,
``alpha2``, ``b7`` and ``b1`` are ``[C]``.

:func:`dac_resunit` launches the kernel for CUDA tensors and runs
:func:`dac_resunit_reference` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.ops import _build

__all__ = ["dac_resunit", "dac_resunit_reference", "snake"]

MAX_CHANNELS = 256  # the widest unit the kernel takes
# The kernel's layout (csrc/dac_resunit.cu: kTile, kRound): a block holds a
# window of C channels x (64 + 6d) samples in shared memory, of which a block
# may use 232448 bytes on Hopper, and reads the weights with their output
# channels zero-padded to whole rounds of 96.
_TILE, _ROUND, _SMEM_LIMIT = 64, 96, 232448

_P = ctypes.c_void_p
_lib_cache: list = []


def _lib():
    if not _lib_cache:
        lib = _build.load("dac_resunit")
        lib.dac_resunit_f32.argtypes = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
        lib.dac_resunit_f32.restype = ctypes.c_int
        lib.dac_resunit_error_string.argtypes = [ctypes.c_int]
        lib.dac_resunit_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation ``x + sin²(αx)/(α + 1e-9)``; ``x`` [B, C, T],
    ``alpha`` [C]."""
    alpha = alpha[:, None]
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def dac_resunit_reference(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int):
    """Plain unit: snake → ``F.conv1d(padding=3d, dilation=d)`` → snake →
    1×1 ``F.conv1d`` → residual add, with TF32 off."""
    with exact_fp32():
        h = snake(x, alpha1)
        h = F.conv1d(h, w7, b7, padding=3 * dilation, dilation=dilation)
        h = snake(h, alpha2)
        return x + F.conv1d(h, w1, b1)


def _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS}, got C={C}")
    if dilation < 1 or 4 * C * (_TILE + 6 * dilation) > _SMEM_LIMIT:
        raise ValueError(f"dilation {dilation} at C={C} does not fit the "
                         "kernel's shared-memory window")
    shapes = {"x": (x, (B, C, T)), "w7": (w7, (C, C, 7)), "b7": (b7, (C,)),
              "alpha1": (alpha1, (C,)), "w1": (w1, (C, C, 1)),
              "b1": (b1, (C,)), "alpha2": (alpha2, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dac_resunit(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int):
    """The fused unit: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` float32. On the card the kernel
    takes contiguous float32 tensors and ``C <= 256``; anything else
    raises."""
    if x.device.type == "cpu":
        return dac_resunit_reference(x, w7, b7, alpha1, w1, b1, alpha2,
                                     dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation)
    B, C, T = x.shape
    lib = _lib()
    # weights as [Cin][tap][Cout], Cout zero-padded to the kernel's rounds
    Cp = _ROUND * -(-C // _ROUND)
    w7t = x.new_zeros(C, 7, Cp)
    w7t[:, :, :C] = w7.permute(1, 2, 0)
    w1t = x.new_zeros(C, Cp)
    w1t[:, :C] = w1[:, :, 0].T
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dac_resunit_f32(
            x.data_ptr(), w7t.data_ptr(), b7.data_ptr(), alpha1.data_ptr(),
            w1t.data_ptr(), b1.data_ptr(), alpha2.data_ptr(), out.data_ptr(),
            B, C, T, dilation, stream)
    if err:
        raise RuntimeError("dac_resunit kernel launch failed: "
                           + lib.dac_resunit_error_string(err).decode())
    dac_resunit.launches += 1
    return out


dac_resunit.launches = 0  # kernel launches in this process
