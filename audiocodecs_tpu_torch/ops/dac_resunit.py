"""Fused DAC residual unit: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/dac_resunit.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/dac_resunit_pallas.py::dac_resunit_pallas``: one pass
over ``x`` per block of (batch, time tile) computes

    out = x + conv1(snake(conv7_d(snake(x, α1)) + b7, α2)) + b1

with zero padding of 3·d on both sides of the dilated k7 conv, so the output
has the input's length. The source's header states its bound and design.

Layout is PyTorch's ``[B, C, T]``. Weights are conv weights in PyTorch's
``[Cout, Cin, K]``: ``w7 [C, C, 7]``, ``w1 [C, C, 1]``; ``alpha1``,
``alpha2``, ``b7`` and ``b1`` are ``[C]``. The kernel reads the two conv
weights in its own layout, :func:`pack_resunit_weights`, which a caller
builds once and passes as ``packed``.

:func:`dac_resunit` launches the kernel for CUDA tensors and runs
:func:`dac_resunit_reference` for CPU tensors; there is no other path.
Its gradient recomputes through the plain version (:class:`_Unit`), on
both devices.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.ops import _build
from audiocodecs_tpu_torch.ops._autograd import recompute_vjp

__all__ = ["dac_resunit", "dac_resunit_info", "dac_resunit_reference",
           "pack_resunit_weights", "snake"]

MAX_CHANNELS = 256  # the widest unit the kernel takes
# The kernel's layout (csrc/dac_resunit.cu: kTile, kChunk, kStages and the
# three tiles): a block computes 128 samples of every output channel,
# padded to _padded_channels(C), and streams the input channels in chunks
# of 8 through a two-stage ring in shared memory, of which a block may use
# 232448 bytes on Hopper.
_TILE, _CHUNK, _STAGES, _SMEM_LIMIT = 128, 8, 2, 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_cache: list = []


def _lib():
    if not _lib_cache:
        lib = _build.load("dac_resunit")
        lib.dac_resunit_f32.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.dac_resunit_f32.restype = _I
        lib.dac_resunit_info.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
        lib.dac_resunit_info.restype = _I
        lib.dac_resunit_error_string.argtypes = [_I]
        lib.dac_resunit_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _padded_channels(C: int) -> int:
    """Output channels of the kernel's tile for C (csrc: ``prepare``)."""
    return 96 if C <= 96 else 192 if C <= 192 else 256


def _padded_inputs(C: int) -> int:
    return _CHUNK * -(-C // _CHUNK)


def _smem_bytes(C: int, dilation: int) -> int:
    """Shared memory of a block (csrc: ``Layout::floats``): the k7 ring or
    h plus the w1 ring, whichever is larger."""
    Cp = _padded_channels(C)
    stride = (_TILE + 6 * dilation + 3) // 4 * 4
    ring = _STAGES * (_CHUNK * 7 * Cp + _CHUNK * stride)
    return 4 * max(ring, Cp * _TILE + _STAGES * _CHUNK * Cp)


def pack_resunit_weights(w7: torch.Tensor, w1: torch.Tensor):
    """The conv weights in the kernel's layout: ``w7p [Kp, 7, Cp]`` with
    ``w7p[c, k, o] = w7[o, c, k]`` and ``w1p [Kp, Cp]`` with
    ``w1p[m, o] = w1[o, m, 0]``. Input channels are zero-padded to
    ``Kp = 8·⌈C/8⌉`` and output channels to ``Cp`` (96, 192 or 256 by C),
    on ``w7``'s device, detached."""
    C = w7.shape[0]
    Kp, Cp = _padded_inputs(C), _padded_channels(C)
    with torch.no_grad():
        w7p = w7.new_zeros(Kp, 7, Cp)
        w7p[:C, :, :C] = w7.permute(1, 2, 0)
        w1p = w1.new_zeros(Kp, Cp)
        w1p[:C, :C] = w1[:, :, 0].T
    pack_resunit_weights.packs += 1
    return w7p, w1p


pack_resunit_weights.packs = 0  # layouts built in this process


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


def _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed=None):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS}, got C={C}")
    if dilation < 1 or _smem_bytes(C, dilation) > _SMEM_LIMIT:
        raise ValueError(f"dilation {dilation} at C={C} does not fit the "
                         "kernel's shared memory")
    shapes = {"x": (x, (B, C, T)), "w7": (w7, (C, C, 7)), "b7": (b7, (C,)),
              "alpha1": (alpha1, (C,)), "w1": (w1, (C, C, 1)),
              "b1": (b1, (C,)), "alpha2": (alpha2, (C,))}
    if packed is not None:
        Kp, Cp = _padded_inputs(C), _padded_channels(C)
        shapes["packed w7"] = (packed[0], (Kp, 7, Cp))
        shapes["packed w1"] = (packed[1], (Kp, Cp))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed):
    _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed)
    if packed is None:
        packed = pack_resunit_weights(w7, w1)
    w7p, w1p = packed
    B, C, T = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dac_resunit_f32(
            x.data_ptr(), w7p.data_ptr(), b7.data_ptr(), alpha1.data_ptr(),
            w1p.data_ptr(), b1.data_ptr(), alpha2.data_ptr(), out.data_ptr(),
            B, C, T, dilation, stream)
    if err:
        raise RuntimeError("dac_resunit kernel launch failed: "
                           + lib.dac_resunit_error_string(err).decode())
    dac_resunit.launches += 1
    return out


class _Unit(torch.autograd.Function):
    """The unit with a recompute gradient rule: the forward launches the
    kernel (CUDA tensors) or runs the plain version (CPU tensors); the
    backward recomputes through :func:`dac_resunit_reference` and returns
    the VJP for ``x``, both convs and both ``alpha``s. ``packed`` is a
    detached side input: it gets no gradient and is not saved."""

    @staticmethod
    def forward(ctx, x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w7, b7, alpha1, w1, b1, alpha2)
        ctx.dilation = dilation
        if x.device.type == "cpu":
            return dac_resunit_reference(x, w7, b7, alpha1, w1, b1, alpha2,
                                         dilation)
        return _launch(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        grads = recompute_vjp(dac_resunit_reference, "dac_resunit.backward",
                              (*ctx.saved_tensors, ctx.dilation), (g_out,),
                              ctx.needs_input_grad[:8])
        return (*grads, None)


def dac_resunit(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int, *,
                packed=None):
    """The fused unit: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` float32. On the card the kernel
    takes contiguous float32 tensors and ``C <= 256``; anything else
    raises. ``packed`` is :func:`pack_resunit_weights` of ``(w7, w1)``;
    without it the kernel's layout is built for this call. The CPU path
    ignores it. Differentiable on both devices (:class:`_Unit`): the
    backward recomputes through the plain version and launches no
    kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return _Unit.apply(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed)


dac_resunit.launches = 0  # kernel launches in this process


def dac_resunit_info(C: int, dilation: int) -> dict:
    """The kernel's occupancy for a unit of C channels at ``dilation`` on
    the current card: registers a thread, shared bytes a block and resident
    blocks an SM (CUDA's attribute and occupancy queries)."""
    lib = _lib()
    regs, smem, blocks = _I(), _I(), _I()
    err = lib.dac_resunit_info(C, dilation, ctypes.byref(regs),
                               ctypes.byref(smem), ctypes.byref(blocks))
    if err:
        raise RuntimeError("dac_resunit_info failed: "
                           + lib.dac_resunit_error_string(err).decode())
    return {"regs": regs.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}
