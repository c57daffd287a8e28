"""Fused SEANet residual block: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/seanet_resblock.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/seanet_block_pallas.py::seanet_resblock_pallas``:
one pass over ``x`` per block of (batch, time tile) computes

    out = shortcut(x) + conv1x1(ELU(conv3(ELU(x_padded))))

and writes the tile once. The source's header states its bound and design.

Layout is PyTorch's ``[B, C, T]``. The two causal samples before ``t = 0``
come in as ``halo [B, C, 2]`` (reflect or zero, per the model's pad mode), so
``x`` is never copied into a padded buffer. Weights are conv weights in
PyTorch's ``[Cout, Cin, K]``: ``w1 [Hc, C, 3]``, ``w2 [C, Hc, 1]``,
``ws [C, C, 1]``.

:func:`seanet_resblock` launches the kernel for CUDA tensors and runs
:func:`seanet_resblock_reference` for CPU tensors; there is no other path.

:func:`seanet_resblock_packed` is the entry point that replaces the TPU
kernel ``audiocodecs_tpu/ops/seanet_block_packed.py::seanet_resblock_packed``
with that function's contract: channel-last ``x [B, T, C]``, a zero causal
pad, ``C <= 64``. The TPU kernel packs ``128 // C`` time samples into the
lanes of its matrix unit; that has no meaning on Hopper, whose kernel here
already walks time across threads. So the entry point converts the layout
and launches the same kernel as :func:`seanet_resblock`, with a zero halo,
and counts its launches apart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import elu, exact_fp32
from audiocodecs_tpu_torch.ops import _build

__all__ = ["seanet_resblock", "seanet_resblock_reference",
           "seanet_resblock_packed", "seanet_resblock_packed_reference"]

MAX_CHANNELS = 384  # the widest register tile the kernel is built with

_P = ctypes.c_void_p
_lib_cache: list = []


def _lib():
    if not _lib_cache:
        lib = _build.load("seanet_resblock")
        lib.seanet_resblock_f32.argtypes = [_P] * 9 + [ctypes.c_int] * 4 + [_P]
        lib.seanet_resblock_f32.restype = ctypes.c_int
        lib.seanet_resblock_error_string.argtypes = [ctypes.c_int]
        lib.seanet_resblock_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs):
    """Plain block: ELU → k3 conv → ELU → 1×1 conv, plus a 1×1 shortcut,
    with ``F.conv1d`` (TF32 off). ``x`` [B, C, T], ``halo`` [B, C, 2]."""
    with exact_fp32():
        h = elu(torch.cat([halo, x], dim=-1))
        h = elu(F.conv1d(h, w1, b1))
        y = F.conv1d(h, w2, b2)
        return F.conv1d(x, ws, bs) + y


def _check(x, halo, w1, b1, w2, b2, ws, bs):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    Hc = w1.shape[0]
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS}, got C={C}")
    shapes = {"x": (x, (B, C, T)), "halo": (halo, (B, C, 2)),
              "w1": (w1, (Hc, C, 3)), "b1": (b1, (Hc,)),
              "w2": (w2, (C, Hc, 1)), "b2": (b2, (C,)),
              "ws": (ws, (C, C, 1)), "bs": (bs, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, halo, w1, b1, w2, b2, ws, bs):
    _check(x, halo, w1, b1, w2, b2, ws, bs)
    B, C, T = x.shape
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.seanet_resblock_f32(
            x.data_ptr(), halo.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            out.data_ptr(), B, C, w1.shape[0], T, stream)
    if err:
        raise RuntimeError("seanet_resblock kernel launch failed: "
                           + lib.seanet_resblock_error_string(err).decode())
    return out


def seanet_resblock(x, halo, w1, b1, w2, b2, ws, bs):
    """The fused block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` float32. On the card the kernel
    takes float32 and ``C <= 384``; anything else raises."""
    if x.device.type == "cpu":
        return seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _launch(x, halo, w1, b1, w2, b2, ws, bs)
    seanet_resblock.launches += 1
    return out


seanet_resblock.launches = 0  # kernel launches in this process

PACKED_MAX_CHANNELS = 64  # the TPU kernel's limit (two samples a lane row)


def _packed_args(x, w1, b1, w2, b2, ws, bs):
    """The reference layouts (``x [B, T, C]``, ``w1 [3, C, H]``,
    ``w2 [H, C]``, ``ws [C, C]``) as the block's ``[B, C, T]`` arguments,
    with a zero causal halo."""
    if x.ndim != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    if C > PACKED_MAX_CHANNELS:
        raise ValueError(f"seanet_resblock_packed needs C <= "
                         f"{PACKED_MAX_CHANNELS}; got C={C}")
    xc = x.transpose(1, 2).contiguous()
    return (xc, xc.new_zeros(B, C, 2), w1.permute(2, 1, 0).contiguous(), b1,
            w2.T.contiguous()[..., None], b2, ws.T.contiguous()[..., None], bs)


def seanet_resblock_packed_reference(x, w1, b1, w2, b2, ws, bs):
    """Plain version of :func:`seanet_resblock_packed`: the block's plain
    version on the converted layout. Returns ``[B, T, C]``."""
    args = _packed_args(x, w1, b1, w2, b2, ws, bs)
    return seanet_resblock_reference(*args).transpose(1, 2)


def seanet_resblock_packed(x, w1, b1, w2, b2, ws, bs):
    """The SEANet block with the packed TPU kernel's contract: ``x``
    [B, T, C] unpadded (the causal left side is zero), ``w1`` [3, C, H],
    ``w2`` [H, C], ``ws`` [C, C]; returns [B, T, C]. Raises ``ValueError``
    for C > 64. CUDA tensors launch the block kernel, CPU tensors run its
    plain version."""
    if x.device.type == "cpu":
        return seanet_resblock_packed_reference(x, w1, b1, w2, b2, ws, bs)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _launch(*_packed_args(x, w1, b1, w2, b2, ws, bs))
    seanet_resblock_packed.launches += 1
    return out.transpose(1, 2)


seanet_resblock_packed.launches = 0  # kernel launches in this process
