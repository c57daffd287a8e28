"""Fused SEANet residual block: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/seanet_resblock.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/seanet_block_pallas.py::seanet_resblock_pallas``:
one pass over ``x`` per block of (batch, time tile) computes

    out = shortcut(x) + conv1x1(ELU(conv3(ELU(x_padded))))

and writes the tile once. The source's header states its bound and design.

It comes in the reference kernel's forms (its ``precision_name``):

* ``precision="exact"``: fp32 throughout, on the CUDA cores (the
  reference's ``"highest"``, and its ``"high"``, which Mosaic lowers to the
  same). ``x`` is float32.
* ``precision="default"``: one bf16 pass with fp32 sums, on the tensor
  cores. ``x`` is float32 (the reference's only input dtype) or bfloat16
  (the reference's caller casts a bf16 block input to f32 and the result
  back, ``audiocodecs_tpu/nn/seanet.py:156-167``; the kernel fuses both
  casts into its load and its store). The halo, weights and biases have
  ``x``'s dtype, and so has the output.

The default form rounds where the TPU's one pass rounds: the k3 conv's
operand h = ELU(x_padded) to bf16, and w1; the k3 sums in fp32, then + b1,
ELU in fp32, then h2 to bf16, and w2; the 1×1 sums in fp32, then + b2; the
shortcut sums bf16(x) · bf16(ws) in fp32, then + bs; out = (s + bs) +
(y + b2) in fp32, rounded once to ``x``'s dtype.

Layout is PyTorch's ``[B, C, T]``. The two causal samples before ``t = 0``
come in as ``halo [B, C, 2]`` (reflect or zero, per the model's pad mode), so
``x`` is never copied into a padded buffer. Weights are conv weights in
PyTorch's ``[Cout, Cin, K]``: ``w1 [Hc, C, 3]``, ``w2 [C, Hc, 1]``,
``ws [C, C, 1]``. The kernel reads the three conv weights in its own
layout for the form, :func:`pack_resblock_weights`, which a caller builds
once and passes as ``packed``.

:func:`seanet_resblock` launches the kernel for CUDA tensors and runs
:func:`seanet_resblock_reference` for CPU tensors; there is no other path.
Its gradient recomputes through the plain version in the same form
(:class:`_Block`), on both devices; where no input needs a gradient (or
grad mode is off) the call runs the same forward without the Function.
Launches are counted by form: ``seanet_resblock.launches`` (exact) and
``seanet_resblock.launches_by_form`` (``"default_f32"``,
``"default_bf16"``).

:func:`seanet_resblock_packed` is the entry point that replaces the TPU
kernel ``audiocodecs_tpu/ops/seanet_block_packed.py::seanet_resblock_packed``
with that function's contract: channel-last ``x [B, T, C]``, a zero causal
pad, ``C <= 64``. The TPU kernel packs ``128 // C`` time samples into the
lanes of its matrix unit; that has no meaning on Hopper, whose kernel here
already walks time across threads. So the entry point converts the layout
and launches the same kernel as :func:`seanet_resblock`, in either form,
with a zero halo, and counts its launches apart.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import elu, exact_fp32
from audiocodecs_tpu_torch.ops import _build
from audiocodecs_tpu_torch.ops._autograd import recompute_vjp
from audiocodecs_tpu_torch.ops.dac_resunit import operand_offsets

__all__ = ["DEFAULT_FORMS", "PRECISIONS", "default_errors", "default_head",
           "default_k3", "default_tail", "form_name",
           "operand_offsets", "pack_resblock_weights", "seanet_resblock",
           "seanet_resblock_elu_check", "seanet_resblock_info",
           "seanet_resblock_reference",
           "seanet_resblock_packed", "seanet_resblock_packed_reference",
           "seanet_resblock_stages"]

MAX_CHANNELS = 384  # the widest tile the kernel is built with (C and Hc)
PRECISIONS = ("exact", "default")
# the one-pass form by its operands' dtype, as ``launches_by_form`` keys it
DEFAULT_FORMS = ("default_f32", "default_bf16")
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
        lib.seanet_resblock_default.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        lib.seanet_resblock_default.restype = _I
        lib.seanet_resblock_default_info.argtypes = (
            [_I] * 3 + [ctypes.POINTER(_I)] * 5)
        lib.seanet_resblock_default_info.restype = _I
        lib.seanet_resblock_elu_check.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_uint)]
        lib.seanet_resblock_elu_check.restype = _I
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


def form_name(precision: str, dtype=torch.float32) -> str:
    """The form's name: ``"exact"``, or one of :data:`DEFAULT_FORMS`."""
    if precision == "exact":
        return "exact"
    return "default_bf16" if dtype == torch.bfloat16 else "default_f32"


# The one-pass kernel's instances (csrc: mma::Cfg, mma::pick): the first
# row with C <= CP and Hc <= HP. Each: (CP, HP, NP1 hidden channels a k3
# pass, NP2 output channels a 1x1/shortcut pass, blocks an SM, op stages,
# weights resident, channels a raw tile). Items are 64 samples; K chunks
# 16 channels; raw tiles 72 samples; streamed weights in stages of
# 12,288 bytes.
_MMA_TILES = ((32, 16, 16, 32, 2, 2, True, 32),
              (64, 32, 32, 32, 2, 2, True, 64),
              (128, 64, 64, 64, 1, 2, True, 64),
              (256, 128, 64, 64, 1, 2, False, 32),
              (MAX_CHANNELS, MAX_CHANNELS, 64, 64, 1, 1, False, 32))
_MMA_TILE, _MMA_ROWS, _MMA_CHUNK, _MMA_WSTAGE = 64, 72, 16, 12288
_SMEM_LIMIT, _SMEM_SM = 232448, 233472


def _mma_tile(C: int, Hc: int):
    """The one-pass instance for (C, Hc): (CP, HP, NP1, NP2, MINB, SO,
    RES, RC)."""
    if C > MAX_CHANNELS or Hc > MAX_CHANNELS:
        raise ValueError(f"kernel takes C, Hc <= {MAX_CHANNELS}, got "
                         f"C={C}, Hc={Hc}")
    return next(t for t in _MMA_TILES if C <= t[0] and Hc <= t[1])


def _mma_layout(C: int, Hc: int, dtype=torch.float32) -> dict:
    """The one-pass instance's shared-memory layout (csrc: ``mma::Cfg``):
    raw ring stages ``SR``, weight ring stages ``SW`` (0: resident) and the
    block's bytes ``smem``, besides the instance's row."""
    CP, HP, NP1, NP2, MINB, SO, RES, RC = _mma_tile(C, Hc)
    esize = 2 if dtype == torch.bfloat16 else 4
    budget = _SMEM_LIMIT if MINB == 1 else _SMEM_SM // MINB - 1024
    consts = -(-4 * (HP + 2 * CP) // 128) * 128
    wres = 8 * HP * CP + 2 * CP * CP if RES else 0
    op = (_MMA_ROWS + _MMA_TILE) * CP * 2
    fixed = (256 + consts + wres + SO * op + _MMA_TILE * HP * 2
             + NP2 * _MMA_TILE * 4)
    raw = RC * _MMA_ROWS * esize
    SR = min(4, (budget - fixed) // raw) if RES else 2
    SW = 0 if RES else min(8, (budget - fixed - SR * raw) // _MMA_WSTAGE)
    return {"CP": CP, "HP": HP, "NP1": NP1, "NP2": NP2, "MINB": MINB,
            "SO": SO, "RES": RES, "RC": RC, "SR": SR, "SW": SW,
            "smem": fixed + SR * raw + SW * _MMA_WSTAGE}


def _k_major(mat: torch.Tensor, n_pad: int, nk: int) -> torch.Tensor:
    """``mat [N, K, taps]`` (output channels, input channels, taps) as
    bf16 wgmma B operands, K-major without swizzle, ``[⌈N/n_pad⌉, nk,
    taps, 2, n_pad, 8]``: passes of ``n_pad`` output channels, ``nk``
    chunks of 16 input channels, the taps, then a chunk's two planes of 8
    input channels, a 16-byte row an output channel. Element (o, c, tap)
    lies at ``[o // n_pad, c // 16, tap, (c // 8) % 2, o % n_pad,
    c % 8]``; zero past the matrix."""
    N, K, taps = mat.shape
    passes = -(-N // n_pad)
    padded = mat.new_zeros(passes * n_pad, 16 * nk, taps,
                           dtype=torch.bfloat16)
    padded[:N, :K] = mat.to(torch.bfloat16)
    return padded.view(passes, n_pad, nk, 2, 8, taps).permute(
        0, 2, 5, 3, 1, 4).contiguous()


def pack_resblock_weights(w1: torch.Tensor, w2: torch.Tensor,
                          ws: torch.Tensor, precision: str = "exact"):
    """The conv weights in the kernel's layout for ``precision``, on
    ``w1``'s device, detached.

    Exact: ``w1p [Kp, 3, M1p]`` with ``w1p[c, k, m] = w1[m, c, k]``,
    ``w2p [Khp, Cp]`` with ``w2p[m, o] = w2[o, m, 0]`` and ``wsp [Kp, Cp]``
    with ``wsp[c, o] = ws[o, c, 0]``, float32. Input channels are
    zero-padded to multiples of 8 (``Kp``, ``Khp``), output channels to the
    tile's ``M1p`` and ``Cp``.

    Default: bf16 (rounded to nearest even) as wgmma's B operand, K-major
    without swizzle (:func:`_k_major`), in the instance's passes
    (:func:`_mma_tile`): ``w1f [⌈Hc/NP1⌉, ⌈C/16⌉, 3, 2, NP1, 8]`` with
    ``w1f[p, q, k, h, n, e] = w1[NP1 p + n, 16q + 8h + e, k]``,
    ``w2f [⌈C/NP2⌉, ⌈Hc/16⌉, 1, 2, NP2, 8]`` of ``w2`` and
    ``wsf [⌈C/NP2⌉, ⌈C/16⌉, 1, 2, NP2, 8]`` of ``ws`` likewise. A
    chunk's tap is the [NP, 16] operand at LBO = NP · 16, SBO = 128 bytes
    (:func:`operand_offsets`); the three tensors back to back (w1f, wsf,
    w2f) are the kernel's resident weights."""
    with torch.no_grad():
        if precision == "default":
            Hc, C = w1.shape[:2]
            _, _, NP1, NP2 = _mma_tile(C, Hc)[:4]
            nq, nqh = -(-C // _MMA_CHUNK), -(-Hc // _MMA_CHUNK)
            packed = (_k_major(w1, NP1, nq), _k_major(w2, NP2, nqh),
                      _k_major(ws, NP2, nq))
        else:
            Hc, C = w1.shape[:2]
            Kp, Khp, M1p, Cp = _layout(C, Hc)
            w1p = w1.new_zeros(Kp, 3, M1p)
            w1p[:C, :, :Hc] = w1.permute(1, 2, 0)
            w2p = w2.new_zeros(Khp, Cp)
            w2p[:Hc, :C] = w2[:, :, 0].T
            wsp = ws.new_zeros(Kp, Cp)
            wsp[:C, :C] = ws[:, :, 0].T
            packed = (w1p, w2p, wsp)
    pack_resblock_weights.packs += 1
    return packed


pack_resblock_weights.packs = 0  # layouts built in this process


@functools.lru_cache(maxsize=None)
def _packed_shapes(C: int, Hc: int, precision: str):
    if precision == "default":
        _, _, NP1, NP2 = _mma_tile(C, Hc)[:4]
        nq, nqh = -(-C // _MMA_CHUNK), -(-Hc // _MMA_CHUNK)
        p1, p2 = -(-Hc // NP1), -(-C // NP2)
        return ((p1, nq, 3, 2, NP1, 8), (p2, nqh, 1, 2, NP2, 8),
                (p2, nq, 1, 2, NP2, 8))
    Kp, Khp, M1p, Cp = _layout(C, Hc)
    return (Kp, 3, M1p), (Khp, Cp), (Kp, Cp)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def default_k3(x, halo, w1, b1):
    """The default form's k3 conv before its rounding point: ``(v, mag)``,
    v = Σ bf16(ELU(x_padded)) · bf16(w1) + b1 in fp32 and mag = Σ|terms| +
    |b1|, the scale of v's summation error, both float32 [B, Hc, T]. The
    conv is ``F.conv1d`` on the rounded operands (TF32 off), whose products
    are exact in fp32."""
    h = _bf16(elu(torch.cat([halo, x], dim=-1).float()))
    w = _bf16(w1.float())
    with exact_fp32():
        v = F.conv1d(h, w) + b1.float()[:, None]
        mag = F.conv1d(h.abs(), w.abs()) + b1.float().abs()[:, None]
    return v, mag


def default_head(x, halo, w1, b1) -> torch.Tensor:
    """The default form up to its last rounding point: h2 =
    bf16(ELU(:func:`default_k3`)), bf16 [B, Hc, T]."""
    return elu(default_k3(x, halo, w1, b1)[0]).to(torch.bfloat16)


def default_tail(x, h2, w2, b2, ws, bs) -> torch.Tensor:
    """The default form from h2 on: (Σ bf16(x) · bf16(ws) + bs) +
    (Σ h2 · bf16(w2) + b2) in fp32, rounded once to ``x``'s dtype."""
    with exact_fp32():
        y = F.conv1d(h2.float(), _bf16(w2.float()))
        s = F.conv1d(_bf16(x.float()), _bf16(ws.float()))
    out = (s + bs.float()[:, None]) + (y + b2.float()[:, None])
    return out.to(x.dtype)


def seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs, *,
                              precision: str = "exact"):
    """Plain block. Exact: ELU → k3 conv → ELU → 1×1 conv, plus a 1×1
    shortcut, with ``F.conv1d`` (TF32 off). Default: :func:`default_tail`
    of :func:`default_head`, the rounding points of the one bf16 pass.
    ``x`` [B, C, T], ``halo`` [B, C, 2]."""
    if precision == "default":
        h2 = default_head(x, halo, w1, b1)
        return default_tail(x, h2, w2, b2, ws, bs)
    with exact_fp32():
        h = elu(torch.cat([halo, x], dim=-1))
        h = elu(F.conv1d(h, w1, b1))
        y = F.conv1d(h, w2, b2)
        return F.conv1d(x, ws, bs) + y


def _check_form(x, precision):
    """The form's rules, on every device: a known precision, and bf16
    operands only in the default form."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if x.dtype == torch.bfloat16 and precision != "default":
        raise TypeError("bf16 operands take precision='default' (one bf16 "
                        "pass); 'exact' is fp32 only")


def _check(x, halo, w1, b1, w2, b2, ws, bs, packed=None, precision="exact"):
    """What the kernel does not take raises here, before any launch (one
    pass over the tensors: it runs before every launch)."""
    _check_form(x, precision)
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    Hc = w1.shape[0]
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS or Hc > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS} (and Hc <= "
                         f"{MAX_CHANNELS}), got C={C}, Hc={Hc}")
    dtype, device = x.dtype, x.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: kernel takes float32 or bfloat16, got {dtype}")
    named = [("x", x, (B, C, T), dtype), ("halo", halo, (B, C, 2), dtype),
             ("w1", w1, (Hc, C, 3), dtype), ("b1", b1, (Hc,), dtype),
             ("w2", w2, (C, Hc, 1), dtype), ("b2", b2, (C,), dtype),
             ("ws", ws, (C, C, 1), dtype), ("bs", bs, (C,), dtype)]
    if packed is not None:
        pdtype = (torch.bfloat16 if precision == "default"
                  else torch.float32)
        for name, t, shape in zip(("w1", "w2", "ws"), packed,
                                  _packed_shapes(C, Hc, precision)):
            if t.data_ptr() % 16:  # the kernel copies it in 16-byte pieces
                raise ValueError(f"packed {name} must be 16-byte aligned")
            named.append((f"packed {name}", t, shape, pdtype))
    for name, t, shape, want in named:
        if t.shape != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != want:
            raise TypeError(f"{name}: kernel takes {want} here, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, halo, w1, b1, w2, b2, ws, bs, packed=None, precision="exact",
            h2=None, k3=None):
    _check(x, halo, w1, b1, w2, b2, ws, bs, packed, precision)
    if packed is None:
        packed = pack_resblock_weights(w1, w2, ws, precision)
    w1p, w2p, wsp = packed
    B, C, T = x.shape
    out = torch.empty_like(x)
    lib = _lib()
    # on x's card (a device switch only where it is not the current one)
    index = x.device.index
    switch = (torch.cuda.device(index)
              if index is not None and index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), halo.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                w2p.data_ptr(), b2.data_ptr(), wsp.data_ptr(), bs.data_ptr(),
                out.data_ptr())
        if precision == "default":
            err = lib.seanet_resblock_default(
                *ptrs, None if h2 is None else h2.data_ptr(),
                None if k3 is None else k3.data_ptr(), B, C, w1.shape[0], T,
                int(x.dtype == torch.bfloat16), stream)
        else:
            err = lib.seanet_resblock_f32(*ptrs, B, C, w1.shape[0], T,
                                          stream)
    if err:
        raise RuntimeError("seanet_resblock kernel launch failed: "
                           + lib.seanet_resblock_error_string(err).decode())
    return out


def _forward(counter, x, halo, w1, b1, w2, b2, ws, bs, packed, precision):
    """The block's value: the kernel (CUDA tensors; ``counter``, the entry
    point, counts the launch by form) or the plain version (CPU
    tensors)."""
    if x.device.type == "cpu":
        return seanet_resblock_reference(x, halo, w1, b1, w2, b2, ws, bs,
                                         precision=precision)
    out = _launch(x, halo, w1, b1, w2, b2, ws, bs, packed, precision)
    if precision == "exact":
        counter.launches += 1
    else:
        counter.launches_by_form[form_name(precision, x.dtype)] += 1
    return out


class _Block(torch.autograd.Function):
    """The block with a recompute gradient rule: the forward launches the
    kernel (CUDA tensors; ``counter``, the entry point, counts the launch
    by form) or runs the plain version (CPU tensors); the backward
    recomputes through :func:`seanet_resblock_reference` in the same form
    and returns the VJP for ``x``, ``halo`` (which the caller built from
    ``x``, so its gradient flows back into ``x`` there) and the six
    weights. ``packed`` is a detached side input: it gets no gradient and
    is not saved."""

    @staticmethod
    def forward(ctx, counter, x, halo, w1, b1, w2, b2, ws, bs, packed,
                precision):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, halo, w1, b1, w2, b2, ws, bs)
        ctx.precision = precision
        return _forward(counter, x, halo, w1, b1, w2, b2, ws, bs, packed,
                        precision)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        def plain(*args):
            return seanet_resblock_reference(*args, precision=ctx.precision)

        grads = recompute_vjp(plain, "seanet_resblock.backward",
                              ctx.saved_tensors, (g_out,),
                              ctx.needs_input_grad[1:9])
        return (None, *grads, None, None)


def _apply(counter, x, halo, w1, b1, w2, b2, ws, bs, packed, precision):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    _check_form(x, precision)
    args = (x, halo, w1, b1, w2, b2, ws, bs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Block.apply(counter, *args, packed, precision)
    # no gradient asked for: the same value without the Function's graph
    return _forward(counter, *args, packed, precision)


def seanet_resblock(x, halo, w1, b1, w2, b2, ws, bs, *, packed=None,
                    precision: str = "exact"):
    """The fused block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` of ``x``'s dtype. ``precision``
    "exact" takes float32; "default" (one bf16 pass) float32 or bfloat16,
    the halo, weights and biases of ``x``'s dtype. On the card the kernel
    takes contiguous tensors and ``C, Hc <= 384``; anything else raises.
    ``packed`` is :func:`pack_resblock_weights` of ``(w1, w2, ws)`` for
    ``precision``; without it the kernel's layout is built for this call.
    The CPU path ignores it. Differentiable on both devices
    (:class:`_Block`): the backward recomputes through the plain version in
    the same form and launches no kernel."""
    return _apply(seanet_resblock, x, halo, w1, b1, w2, b2, ws, bs, packed,
                  precision)


seanet_resblock.launches = 0  # exact-form kernel launches in this process
# one-pass kernel launches in this process, by the operands' dtype
seanet_resblock.launches_by_form = dict.fromkeys(DEFAULT_FORMS, 0)


def seanet_resblock_stages(x, halo, w1, b1, w2, b2, ws, bs, *, packed=None):
    """The default form with its rounding points written out: returns
    ``(out, h2, k3)``, ``h2`` the bf16 input of the 1×1 conv and ``k3`` the
    fp32 value it was rounded from (after ``+ b1``, before ELU). For CUDA
    tensors the kernel writes all three in one launch (not counted as a
    model's launch); for CPU tensors they come from the plain version. A
    check can then hold the kernel to its plain version one rounding point
    at a time (:func:`default_errors`)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    with torch.no_grad():
        if x.device.type == "cpu":
            k3 = default_k3(x, halo, w1, b1)[0]
            h2 = elu(k3).to(torch.bfloat16)
            return default_tail(x, h2, w2, b2, ws, bs), h2, k3
        _check(x, halo, w1, b1, w2, b2, ws, bs, packed, "default")
        shape = (x.shape[0], w1.shape[0], x.shape[2])
        h2 = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
        k3 = torch.empty(shape, dtype=torch.float32, device=x.device)
        out = _launch(x, halo, w1, b1, w2, b2, ws, bs, packed, "default",
                      h2=h2, k3=k3)
    return out, h2, k3


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def default_errors(out, h2, k3, x, halo, w1, b1, w2, b2, ws, bs) -> dict:
    """The default form's kernel (``out``, ``h2``, ``k3`` from
    :func:`seanet_resblock_stages`) against its plain version, one rounding
    point at a time:

    * k3, the fp32 sum before its rounding, within 1e-5 · Σ|terms| of the
      plain version's, elementwise (fp32 sums in another order);
    * h2 within one bf16 ulp of :func:`default_head`'s, plus what the k3
      bound lets through (ELU is 1-Lipschitz): two correct implementations
      disagree wherever their k3 sums straddle a rounding boundary, by one
      ulp, and near zero, where the ulp is finer than the sums' error, by
      more; the share of elements that differ is reported;
    * ``out`` against :func:`default_tail` of the kernel's own h2: fp32
      within 1e-5 · max|tail|; bf16 within one bf16 ulp plus 1e-5 ·
      max|tail| (fp32 sums in another order near a boundary).

    Returns the errors as shares of their limits (``*_ratio``), ``ok``, the
    share of h2 elements that differ and max|out − plain| end to end."""
    with torch.no_grad():
        k3_plain, mag = default_k3(x, halo, w1, b1)
        k3_ratio = float(((k3 - k3_plain).abs() / (1e-5 * mag)).max())
        hp = elu(k3_plain).to(torch.bfloat16).float()
        h2_diff = (h2.float() - hp).abs()
        h2_lim = (torch.maximum(_bf16_ulp(hp), _bf16_ulp(h2.float()))
                  + 1e-5 * mag)
        tail = default_tail(x, h2, w2, b2, ws, bs)
        scale = float(tail.float().abs().max())
        diff = (out.float() - tail.float()).abs()
        if out.dtype == torch.bfloat16:
            ulp = torch.maximum(_bf16_ulp(tail), _bf16_ulp(out))
            out_ratio = float((diff / (ulp + 1e-5 * scale)).max())
        else:
            out_ratio = float(diff.max()) / (1e-5 * scale)
        plain = default_tail(x, hp.to(torch.bfloat16), w2, b2, ws, bs)
        res = {"k3_ratio": k3_ratio,
               "h2_ratio": float((h2_diff / h2_lim).max()),
               "h2_differ": float((h2_diff > 0).float().mean()),
               "tail_err": float(diff.max()), "tail_ratio": out_ratio,
               "max_abs_err": float((out.float() - plain.float()).abs()
                                    .max()),
               "scale": scale}
    res["ok"] = all(res[k] <= 1.0 for k in ("k3_ratio", "h2_ratio",
                                             "tail_ratio"))
    return res


def seanet_resblock_info(C: int, Hc: int, precision: str = "exact",
                         dtype=torch.float32) -> dict:
    """The kernel's budget for a block of C channels and Hc hidden ones in
    a form on the current card: registers and local (spill) bytes a thread,
    shared bytes a block, resident blocks an SM (CUDA's attribute and
    occupancy queries) and time samples a block."""
    lib = _lib()
    out = [_I() for _ in range(5)]
    if precision == "default":
        err = lib.seanet_resblock_default_info(
            C, Hc, int(dtype == torch.bfloat16), *map(ctypes.byref, out))
    else:
        err = lib.seanet_resblock_info(C, Hc, *map(ctypes.byref, out))
    if err:
        raise RuntimeError("seanet_resblock_info failed: "
                           + lib.seanet_resblock_error_string(err).decode())
    keys = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "tile")
    return {k: v.value for k, v in zip(keys, out)}


def seanet_resblock_elu_check() -> dict:
    """The one-pass kernel's ELU (csrc ``mma::elu_for_bf16``: a polynomial
    or ``ex2.approx`` away from bf16 rounding midpoints, ``expm1f`` near
    them) against ``expm1f`` over every float, on the current card:
    ``mismatches``, the values whose bf16 roundings differ (0 is right),
    and ``max_ulps``, the largest fp32-ulp distance of a fast value from
    ``expm1f``'s."""
    bad, far = ctypes.c_ulonglong(), ctypes.c_uint()
    err = _lib().seanet_resblock_elu_check(ctypes.byref(bad),
                                           ctypes.byref(far))
    if err:
        raise RuntimeError("seanet_resblock_elu_check failed: "
                           + _lib().seanet_resblock_error_string(err)
                           .decode())
    return {"mismatches": bad.value, "max_ulps": far.value}


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


def seanet_resblock_packed_reference(x, w1, b1, w2, b2, ws, bs, *,
                                     precision: str = "exact"):
    """Plain version of :func:`seanet_resblock_packed`: the block's plain
    version in the form on the converted layout. Returns ``[B, T, C]``."""
    args = _packed_args(x, w1, b1, w2, b2, ws, bs)
    return seanet_resblock_reference(*args,
                                     precision=precision).transpose(1, 2)


def seanet_resblock_packed(x, w1, b1, w2, b2, ws, bs, *,
                           precision: str = "exact"):
    """The SEANet block with the packed TPU kernel's contract: ``x``
    [B, T, C] unpadded (the causal left side is zero), ``w1`` [3, C, H],
    ``w2`` [H, C], ``ws`` [C, C]; returns [B, T, C]. ``precision`` as
    :func:`seanet_resblock`'s (the reference's ``precision_name``). Raises
    ``ValueError`` for C > 64. CUDA tensors launch the block kernel, CPU
    tensors run its plain version; both through :class:`_Block` after the
    layout copies, so the gradient flows back through them to the caller's
    layouts."""
    out = _apply(seanet_resblock_packed,
                 *_packed_args(x, w1, b1, w2, b2, ws, bs), None, precision)
    return out.transpose(1, 2)


seanet_resblock_packed.launches = 0  # exact-form kernel launches
seanet_resblock_packed.launches_by_form = dict.fromkeys(DEFAULT_FORMS, 0)
