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
``ws [C, C, 1]``. The kernel reads the three conv weights in its own
layout, :func:`pack_resblock_weights`, which a caller builds once and
passes as ``packed``.

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

__all__ = ["pack_resblock_weights", "seanet_resblock",
           "seanet_resblock_info", "seanet_resblock_reference",
           "seanet_resblock_packed", "seanet_resblock_packed_reference"]

MAX_CHANNELS = 384  # the widest tile the kernel is built with (C and Hc)
# The kernel's layout (csrc/seanet_resblock.cu: kChunk, kRT and the tile
# table in ``prepare``): input channels go in chunks of 8; a block's 8 warps
# are WM channel groups x 8 / WM time groups of 64 samples, a warp 4 channel
# lanes; the k3 conv covers M1p = 4 WM RM1 hidden channels, each pass of the
# 1x1 convs P2 = 4 WM RM2 output channels. Rows: (largest Hc, largest C,
# WM, RM1, RM2, weights resident in shared memory).
_CHUNK, _STAGES = 8, 2
_TILES = ((16, 32, 1, 4, 8, True), (32, 64, 2, 4, 8, True),
          (64, MAX_CHANNELS, 4, 4, 8, False),
          (128, MAX_CHANNELS, 8, 4, 8, False),
          (MAX_CHANNELS, MAX_CHANNELS, 8, 12, 8, False))

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_cache: list = []


def _lib():
    if not _lib_cache:
        lib = _build.load("seanet_resblock")
        lib.seanet_resblock_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.seanet_resblock_f32.restype = _I
        lib.seanet_resblock_info.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 5
        lib.seanet_resblock_info.restype = _I
        lib.seanet_resblock_error_string.argtypes = [_I]
        lib.seanet_resblock_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _round8(n: int) -> int:
    return _CHUNK * -(-n // _CHUNK)


def _tile(C: int, Hc: int):
    """The kernel's tile for (C, Hc): (WM, RM1, RM2, resident)."""
    if C > MAX_CHANNELS or Hc > MAX_CHANNELS:
        raise ValueError(f"kernel takes C, Hc <= {MAX_CHANNELS}, got "
                         f"C={C}, Hc={Hc}")
    return next(t[2:] for t in _TILES if Hc <= t[0] and C <= t[1])


def _layout(C: int, Hc: int):
    """Padded sizes of the packed weights: (Kp, Khp, M1p, Cp)."""
    WM, RM1, RM2, _ = _tile(C, Hc)
    P2 = 4 * WM * RM2
    return _round8(C), _round8(Hc), 4 * WM * RM1, P2 * -(-C // P2)


def _smem_bytes(C: int, Hc: int) -> int:
    """Shared memory of a block (csrc: ``Tile::floats``): resident weights,
    then the k3 ring or h plus the 1x1 ring, whichever is larger."""
    WM, RM1, RM2, res = _tile(C, Hc)
    Kp, Khp, M1p, Cp = _layout(C, Hc)
    TT = 512 // WM
    stage1 = (0 if res else _CHUNK * 3 * M1p) + _CHUNK * (TT + 4)
    stage2 = (0 if res else _CHUNK * 4 * WM * RM2) + _CHUNK * TT
    resident = Kp * (3 * M1p + Cp) + Khp * Cp if res else 0
    return 4 * (resident + max(_STAGES * stage1, M1p * TT + _STAGES * stage2))


def pack_resblock_weights(w1: torch.Tensor, w2: torch.Tensor,
                          ws: torch.Tensor):
    """The conv weights in the kernel's layout, on ``w1``'s device,
    detached: ``w1p [Kp, 3, M1p]`` with ``w1p[c, k, m] = w1[m, c, k]``,
    ``w2p [Khp, Cp]`` with ``w2p[m, o] = w2[o, m, 0]`` and ``wsp [Kp, Cp]``
    with ``wsp[c, o] = ws[o, c, 0]``. Input channels are zero-padded to
    multiples of 8 (``Kp``, ``Khp``), output channels to the tile's
    ``M1p`` and ``Cp``."""
    Hc, C = w1.shape[:2]
    Kp, Khp, M1p, Cp = _layout(C, Hc)
    with torch.no_grad():
        w1p = w1.new_zeros(Kp, 3, M1p)
        w1p[:C, :, :Hc] = w1.permute(1, 2, 0)
        w2p = w2.new_zeros(Khp, Cp)
        w2p[:Hc, :C] = w2[:, :, 0].T
        wsp = ws.new_zeros(Kp, Cp)
        wsp[:C, :C] = ws[:, :, 0].T
    pack_resblock_weights.packs += 1
    return w1p, w2p, wsp


pack_resblock_weights.packs = 0  # layouts built in this process


def seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs):
    """Plain block: ELU → k3 conv → ELU → 1×1 conv, plus a 1×1 shortcut,
    with ``F.conv1d`` (TF32 off). ``x`` [B, C, T], ``halo`` [B, C, 2]."""
    with exact_fp32():
        h = elu(torch.cat([halo, x], dim=-1))
        h = elu(F.conv1d(h, w1, b1))
        y = F.conv1d(h, w2, b2)
        return F.conv1d(x, ws, bs) + y


def _check(x, halo, w1, b1, w2, b2, ws, bs, packed=None):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    Hc = w1.shape[0]
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS or Hc > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS} (and Hc <= "
                         f"{MAX_CHANNELS}), got C={C}, Hc={Hc}")
    shapes = {"x": (x, (B, C, T)), "halo": (halo, (B, C, 2)),
              "w1": (w1, (Hc, C, 3)), "b1": (b1, (Hc,)),
              "w2": (w2, (C, Hc, 1)), "b2": (b2, (C,)),
              "ws": (ws, (C, C, 1)), "bs": (bs, (C,))}
    if packed is not None:
        Kp, Khp, M1p, Cp = _layout(C, Hc)
        for name, t, shape in zip(("w1", "w2", "ws"), packed,
                                  ((Kp, 3, M1p), (Khp, Cp), (Kp, Cp))):
            shapes[f"packed {name}"] = (t, shape)
            if t.data_ptr() % 16:  # the kernel copies it in 16-byte pieces
                raise ValueError(f"packed {name} must be 16-byte aligned")
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, halo, w1, b1, w2, b2, ws, bs, packed=None):
    _check(x, halo, w1, b1, w2, b2, ws, bs, packed)
    if packed is None:
        packed = pack_resblock_weights(w1, w2, ws)
    w1p, w2p, wsp = packed
    B, C, T = x.shape
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.seanet_resblock_f32(
            x.data_ptr(), halo.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
            w2p.data_ptr(), b2.data_ptr(), wsp.data_ptr(), bs.data_ptr(),
            out.data_ptr(), B, C, w1.shape[0], T, stream)
    if err:
        raise RuntimeError("seanet_resblock kernel launch failed: "
                           + lib.seanet_resblock_error_string(err).decode())
    return out


def seanet_resblock(x, halo, w1, b1, w2, b2, ws, bs, *, packed=None):
    """The fused block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` float32. On the card the kernel
    takes contiguous float32 tensors and ``C <= 384``; anything else
    raises. ``packed`` is :func:`pack_resblock_weights` of ``(w1, w2, ws)``;
    without it the kernel's layout is built for this call. The CPU path
    ignores it."""
    if x.device.type == "cpu":
        return seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _launch(x, halo, w1, b1, w2, b2, ws, bs, packed)
    seanet_resblock.launches += 1
    return out


seanet_resblock.launches = 0  # kernel launches in this process


def seanet_resblock_info(C: int, Hc: int) -> dict:
    """The kernel's budget for a block of C channels and Hc hidden ones on
    the current card: registers and local (spill) bytes a thread, shared
    bytes a block, resident blocks an SM (CUDA's attribute and occupancy
    queries) and time samples a block."""
    lib = _lib()
    out = [_I() for _ in range(5)]
    err = lib.seanet_resblock_info(C, Hc, *map(ctypes.byref, out))
    if err:
        raise RuntimeError("seanet_resblock_info failed: "
                           + lib.seanet_resblock_error_string(err).decode())
    keys = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "tile")
    return {k: v.value for k, v in zip(keys, out)}


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
