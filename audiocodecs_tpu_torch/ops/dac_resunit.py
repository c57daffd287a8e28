"""Fused DAC residual unit: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/dac_resunit.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/dac_resunit_pallas.py::dac_resunit_pallas``: one pass
over ``x`` per block of (batch, time tile) computes

    out = x + conv1(snake(conv7_d(snake(x, α1)) + b7, α2)) + b1

with zero padding of 3·d on both sides of the dilated k7 conv, so the output
has the input's length. The source's header states its bound and design.

It comes in the reference kernel's forms (its ``precision_name`` and
``snake_poly``):

* ``precision="exact"``: fp32 throughout, on the CUDA cores (the
  reference's ``"highest"``, and its ``"high"``, which Mosaic lowers to the
  same). ``x`` is float32.
* ``precision="default"``: one bf16 pass with fp32 sums, on the tensor
  cores. ``x`` is float32, or bfloat16 (bf16 with ``"exact"`` raises, as
  Mosaic refuses HIGHEST on a bf16 operand). The weights and α have
  ``x``'s dtype, and so has the output.
* ``snake_poly``: the snakes take sin² from an even polynomial after a
  floor-based range reduction (:func:`snake`).

The default form rounds where the TPU's one pass rounds: h = snake(x, α1)
to bf16, and w7; the k7 sums in fp32, then + b7; h2 = snake(·, α2) in
fp32, then to bf16, and w1; the 1×1 sums in fp32, then + b1, then + x in
fp32. The reference writes fp32 and its caller casts back to ``x``'s dtype;
the kernel rounds the same fp32 value once in its epilogue.

Layout is PyTorch's ``[B, C, T]``. Weights are conv weights in PyTorch's
``[Cout, Cin, K]``: ``w7 [C, C, 7]``, ``w1 [C, C, 1]``; ``alpha1``,
``alpha2``, ``b7`` and ``b1`` are ``[C]``. The kernel reads the two conv
weights in its own layout for the form, :func:`pack_resunit_weights`, which
a caller builds once and passes as ``packed``.

:func:`dac_resunit` launches the kernel for CUDA tensors and runs
:func:`dac_resunit_reference` for CPU tensors; there is no other path.
The exact sin form is differentiable: its gradient recomputes through the
plain version (:class:`_Unit`), on both devices. The other forms are for
inference only, as in the reference (its kernel has no VJP): a gradient
through them raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.ops import _build
from audiocodecs_tpu_torch.ops._autograd import recompute_vjp

__all__ = ["FORMS", "PRECISIONS", "dac_resunit", "dac_resunit_info",
           "dac_resunit_reference", "dac_resunit_stages", "default_errors",
           "default_head", "default_tail", "form_name", "operand_offsets",
           "pack_resunit_weights", "snake"]

MAX_CHANNELS = 256  # the widest unit the kernel takes
PRECISIONS = ("exact", "default")
# the forms by name, as the launch counts (dac_resunit.launches_by_form) key
# them: precision, snake, and the operands' dtype of the default form
FORMS = ("exact", "exact_poly", "default_f32", "default_poly_f32",
         "default_bf16", "default_poly_bf16")
# The exact kernel's layout (csrc/dac_resunit.cu: kTile, kChunk, kStages and
# the three tiles): a block computes 128 samples of every output channel,
# padded to _padded_channels(C), and streams the input channels in chunks
# of 8 through a two-stage ring in shared memory, of which a block may use
# 232448 bytes on Hopper.
_TILE, _CHUNK, _STAGES, _SMEM_LIMIT = 128, 8, 2, 232448
# The default form's (mma::Layout): chunks of 16 input channels, output
# channels padded to one of _MMA_CHANNELS, a window of at most 256 rows,
# a weight ring of _MMA_STAGES[cp] stages, two consumer warpgroups, and a
# window ring in the rest of the block's shared memory (at most 16).
_MMA_CHUNK, _MMA_MAX_WINDOW = 16, 256
_MMA_CHANNELS = (48, 96, 192, 256)
_MMA_STAGES = {48: 4, 96: 4, 192: 3, 256: 2}
_MMA_CONSUMERS, _MMA_MAX_WINDOWS = 2, 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_cache: list = []


def _lib():
    if not _lib_cache:
        lib = _build.load("dac_resunit")
        lib.dac_resunit_f32.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.dac_resunit_f32.restype = _I
        lib.dac_resunit_default.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.dac_resunit_default.restype = _I
        lib.dac_resunit_info.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 4
        lib.dac_resunit_info.restype = _I
        lib.dac_resunit_error_string.argtypes = [_I]
        lib.dac_resunit_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def form_name(precision: str, snake_poly: bool, dtype=torch.float32) -> str:
    """The form's name in :data:`FORMS`."""
    if precision == "exact":
        return "exact_poly" if snake_poly else "exact"
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    return f"default_poly_{dt}" if snake_poly else f"default_{dt}"


def _padded_channels(C: int) -> int:
    """Output channels of the exact kernel's tile for C (csrc:
    ``prepare``)."""
    return 96 if C <= 96 else 192 if C <= 192 else 256


def _mma_channels(C: int) -> int:
    """Output channels of the default form's tile for C (csrc:
    ``mma::pick_tile``)."""
    return next(cp for cp in _MMA_CHANNELS if C <= cp)


def _padded_inputs(C: int) -> int:
    return _CHUNK * -(-C // _CHUNK)


def _window_rows(dilation: int) -> int:
    """Rows of a window plane of the default form's ring: 128 + 6d rounded
    up to whole 8-row core matrices (csrc: ``mma::Layout::rows``)."""
    return (_TILE + 6 * dilation + 7) // 8 * 8


def _smem_bytes(C: int, dilation: int, precision: str = "exact") -> int:
    """Shared memory of a block. Exact (csrc: ``Layout::floats``): the k7
    ring or h plus the w1 ring, whichever is larger. Default (csrc:
    ``mma::Layout::bytes``): biases and alphas as fp32 and the barriers,
    the weight ring (a chunk's 7 taps a stage), a staging buffer of 64
    samples x CP bf16 for each consumer warpgroup, and as many window
    stages (two planes of 16-byte rows each) as the rest holds, at most
    16."""
    if precision == "default":
        cp = _mma_channels(C)
        fixed = (16 * cp + 512 + _MMA_STAGES[cp] * 7 * cp * 32
                 + _MMA_CONSUMERS * 128 * cp)
        window = 32 * _window_rows(dilation)
        return fixed + window * min(_MMA_MAX_WINDOWS,
                                    (_SMEM_LIMIT - fixed) // window)
    Cp = _padded_channels(C)
    stride = (_TILE + 6 * dilation + 3) // 4 * 4
    ring = _STAGES * (_CHUNK * 7 * Cp + _CHUNK * stride)
    return 4 * max(ring, Cp * _TILE + _STAGES * _CHUNK * Cp)


def operand_offsets(rows: int, lbo: int, sbo: int) -> torch.Tensor:
    """Byte offsets from a wgmma descriptor's start address of the
    ``rows`` x 16 bf16 elements of a K-major operand without swizzle (csrc:
    ``mma::make_desc``), as a [rows, 16] tensor: 8-row x 16-byte core
    matrices, ``sbo`` bytes apart along the rows, ``lbo`` apart along K,
    so element (r, c) lies at (r // 8)·sbo + (r % 8)·16 + (c // 8)·lbo +
    (c % 8)·2."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(16)[None, :]
    return (r // 8) * sbo + (r % 8) * 16 + (c // 8) * lbo + (c % 8) * 2


def pack_resunit_weights(w7: torch.Tensor, w1: torch.Tensor,
                         precision: str = "exact"):
    """The conv weights in the kernel's layout for ``precision``, on
    ``w7``'s device, detached.

    Exact: ``w7p [Kp, 7, Cp]`` with ``w7p[c, k, o] = w7[o, c, k]`` and
    ``w1p [Kp, Cp]`` with ``w1p[m, o] = w1[o, m, 0]``, float32; input
    channels zero-padded to ``Kp = 8·⌈C/8⌉`` and output channels to ``Cp``
    (96, 192 or 256 by C).

    Default: bf16 (rounded to nearest even) as wgmma's B operand, K-major
    without swizzle: ``w7f [nq, 7, 2, CP, 8]`` with ``w7f[q, k, h, o, e] =
    w7[o, 16q + 8h + e, k]`` and ``w1f [nq, 2, CP, 8]`` with ``w1f[q, h, o,
    e] = w1[o, 16q + 8h + e, 0]``; ``nq = ⌈C/16⌉``, input channels
    zero-padded to 16·nq and output channels to CP (48, 96, 192 or 256 by
    C). A chunk's 7 taps are one contiguous block of 7·CP·32 bytes, which
    the kernel copies into a ring stage at once; each tap (and each chunk
    of w1) is a CP-row operand with LBO = CP·16 and SBO = 128 bytes
    (:func:`operand_offsets`)."""
    C = w7.shape[0]
    with torch.no_grad():
        if precision == "default":
            cp, nq = _mma_channels(C), -(-C // _MMA_CHUNK)
            w7p = w7.new_zeros(cp, 16 * nq, 7, dtype=torch.bfloat16)
            w7p[:C, :C] = w7.to(torch.bfloat16)
            w1p = w1.new_zeros(cp, 16 * nq, dtype=torch.bfloat16)
            w1p[:C, :C] = w1[:, :, 0].to(torch.bfloat16)
            packed = (
                w7p.view(cp, nq, 2, 8, 7).permute(1, 4, 2, 0, 3).contiguous(),
                w1p.view(cp, nq, 2, 8).permute(1, 2, 0, 3).contiguous())
        else:
            Kp, Cp = _padded_inputs(C), _padded_channels(C)
            w7p = w7.new_zeros(Kp, 7, Cp)
            w7p[:C, :, :C] = w7.permute(1, 2, 0)
            w1p = w1.new_zeros(Kp, Cp)
            w1p[:C, :C] = w1[:, :, 0].T
            packed = (w7p, w1p)
    pack_resunit_weights.packs += 1
    return packed


pack_resunit_weights.packs = 0  # layouts built in this process


def _packed_shapes(C: int, precision: str):
    if precision == "default":
        nq, cp = -(-C // _MMA_CHUNK), _mma_channels(C)
        return (nq, 7, 2, cp, 8), (nq, 2, cp, 8)
    Kp, Cp = _padded_inputs(C), _padded_channels(C)
    return (Kp, 7, Cp), (Kp, Cp)


def snake(x: torch.Tensor, alpha: torch.Tensor,
          poly: bool = False) -> torch.Tensor:
    """The kernel's snake ``x + sin²(αx)/(α + 1e-9)``; ``x`` [B, C, T],
    ``alpha`` [C] of ``x``'s dtype. The result is float32 for bf16 ``x``;
    other dtypes compute in their own. On bf16 the sin form rounds each
    operation to bf16, as the reference kernel computes it in the
    operands' type.

    ``poly``: sin²(y) = (1 − cos 2πr)/2 with r = y/π − ⌊y/π + ½⌋ and
    cos 2πr from the even polynomial ``_SNAKE_COS_POLY`` in r², by Horner,
    each step rounded in float32 (the reference kernel's ``_snake(...,
    poly=True)``, whose floor differs from the XLA path's ``round`` only at
    half-integers, where the even polynomial gives the same value). y = αx
    is multiplied in ``x``'s dtype, so it is rounded to bf16 for bf16 ``x``,
    as in the reference."""
    a = alpha[:, None]
    if poly:
        y = _widen(a * x)
        xf, af = _widen(x), _widen(a)
        u = y * (1.0 / math.pi)
        r = u - torch.floor(u + 0.5)
        t = r * r
        cos2 = _SNAKE_COS_POLY[-1] * t + _SNAKE_COS_POLY[-2]
        for c in _SNAKE_COS_POLY[-3::-1]:
            cos2 = cos2 * t + c
        return xf + (0.5 - 0.5 * cos2) / (af + 1e-9)
    return _widen(x + torch.sin(a * x) ** 2 / (a + 1e-9))


def _widen(t: torch.Tensor) -> torch.Tensor:
    """bf16 as float32; other dtypes as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


# cos(2πr) on r ∈ [-½, ½] as an even polynomial in r², each coefficient as
# the float32 the kernel holds (the reference's ``_SNAKE_COS_POLY`` in
# ``audiocodecs_tpu/models/dac.py``, rounded to float32 and written in hex).
_SNAKE_COS_POLY = tuple(float.fromhex(h) for h in (
    "0x1.000000p+0", "-0x1.3bd3c8p+4", "0x1.03c1a8p+6", "-0x1.55ccf2p+6",
    "0x1.e1574ep+5", "-0x1.9f7b4ap+4", "0x1.a1d58ap+2"))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def default_head(x, w7, b7, alpha1, alpha2, dilation: int,
                 snake_poly: bool = False) -> torch.Tensor:
    """The default form up to its last rounding point: h2 =
    bf16(snake(Σ bf16(snake(x, α1)) · bf16(w7) + b7, α2)), bf16 [B, C, T].
    The k7 conv is ``F.conv1d`` in fp32 (TF32 off) on the rounded
    operands, whose products are exact in fp32."""
    h = _bf16(snake(x, alpha1, snake_poly))
    return _head_from(h, _bf16(w7), b7, alpha2, dilation, snake_poly)


def _head_from(h, w7b, b7, alpha2, dilation: int, snake_poly: bool):
    """:func:`default_head` from its rounded operands on: ``h`` (bf16
    values as float32, [B, C, T]) and ``w7b`` (bf16 values, [C, C, 7])."""
    with exact_fp32():
        v = F.conv1d(h, w7b, None, padding=3 * dilation, dilation=dilation)
    v = v + b7.float()[:, None]
    return snake(v, alpha2.float(), snake_poly).to(torch.bfloat16)


def default_tail(x, h2, w1, b1) -> torch.Tensor:
    """The default form from h2 on: x + (Σ h2 · bf16(w1) + b1), in fp32,
    rounded once to ``x``'s dtype."""
    with exact_fp32():
        y = F.conv1d(h2.float(), _bf16(w1))
    return (x.float() + (y + b1.float()[:, None])).to(x.dtype)


def dac_resunit_reference(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int,
                          *, precision: str = "exact",
                          snake_poly: bool = False):
    """Plain unit. Exact: snake → ``F.conv1d(padding=3d, dilation=d)`` →
    snake → 1×1 ``F.conv1d`` → residual add, in fp32 with TF32 off.
    Default: :func:`default_tail` of :func:`default_head`, the rounding
    points of the one bf16 pass."""
    if precision == "default":
        h2 = default_head(x, w7, b7, alpha1, alpha2, dilation, snake_poly)
        return default_tail(x, h2, w1, b1)
    with exact_fp32():
        h = snake(x, alpha1, snake_poly)
        h = F.conv1d(h, w7, b7, padding=3 * dilation, dilation=dilation)
        h = snake(h, alpha2, snake_poly)
        return x + F.conv1d(h, w1, b1)


def _check_form(x, precision):
    """The form's rules, on every device: a known precision, and bf16
    operands only in the default form."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if x.dtype == torch.bfloat16 and precision != "default":
        raise TypeError("bf16 operands take precision='default' (one bf16 "
                        "pass); 'exact' is fp32 only")


def _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed=None,
           precision="exact"):
    """What the kernel does not take raises here, before any launch."""
    _check_form(x, precision)
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    if T < 1:
        raise ValueError("empty signal")
    if C > MAX_CHANNELS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS}, got C={C}")
    if dilation < 1 or _smem_bytes(C, dilation, precision) > _SMEM_LIMIT or (
            precision == "default"
            and _TILE + 6 * dilation > _MMA_MAX_WINDOW):
        raise ValueError(f"dilation {dilation} at C={C} does not fit the "
                         "kernel's shared memory")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: kernel takes float32 or bfloat16, got {x.dtype}")
    shapes = {"x": (x, (B, C, T)), "w7": (w7, (C, C, 7)), "b7": (b7, (C,)),
              "alpha1": (alpha1, (C,)), "w1": (w1, (C, C, 1)),
              "b1": (b1, (C,)), "alpha2": (alpha2, (C,))}
    dtypes = dict.fromkeys(shapes, x.dtype)
    if packed is not None:
        s7, s1 = _packed_shapes(C, precision)
        shapes["packed w7"] = (packed[0], s7)
        shapes["packed w1"] = (packed[1], s1)
        dtypes["packed w7"] = dtypes["packed w1"] = (
            torch.bfloat16 if precision == "default" else torch.float32)
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name}: kernel takes {dtypes[name]} here, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed, precision,
            snake_poly, h2=None):
    _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed, precision)
    if packed is None:
        packed = pack_resunit_weights(w7, w1, precision)
    w7p, w1p = packed
    B, C, T = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), w7p.data_ptr(), b7.data_ptr(),
                alpha1.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                alpha2.data_ptr(), out.data_ptr())
        if precision == "default":
            err = lib.dac_resunit_default(
                *ptrs, None if h2 is None else h2.data_ptr(), B, C, T,
                dilation, int(snake_poly), int(x.dtype == torch.bfloat16),
                stream)
        else:
            err = lib.dac_resunit_f32(*ptrs, B, C, T, dilation,
                                      int(snake_poly), stream)
    if err:
        raise RuntimeError("dac_resunit kernel launch failed: "
                           + lib.dac_resunit_error_string(err).decode())
    dac_resunit.launches_by_form[form_name(precision, snake_poly,
                                           x.dtype)] += 1
    return out


class _Unit(torch.autograd.Function):
    """The unit with a recompute gradient rule: the forward launches the
    kernel (CUDA tensors) or runs the plain version (CPU tensors); the
    backward recomputes through :func:`dac_resunit_reference` and returns
    the VJP for ``x``, both convs and both ``alpha``s. ``packed`` is a
    detached side input: it gets no gradient and is not saved. Only the
    exact sin form has a gradient: the backward of another form raises."""

    @staticmethod
    def forward(ctx, x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed,
                precision, snake_poly):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w7, b7, alpha1, w1, b1, alpha2)
        ctx.dilation = dilation
        ctx.form = form_name(precision, snake_poly, x.dtype)
        if x.device.type == "cpu":
            return dac_resunit_reference(x, w7, b7, alpha1, w1, b1, alpha2,
                                         dilation, precision=precision,
                                         snake_poly=snake_poly)
        return _launch(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed,
                       precision, snake_poly)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        if ctx.form != "exact":
            raise RuntimeError(
                f"dac_resunit: the {ctx.form!r} form is for inference only "
                "(as the reference's kernel, which has no VJP); only the "
                "exact sin form has a gradient")
        grads = recompute_vjp(dac_resunit_reference, "dac_resunit.backward",
                              (*ctx.saved_tensors, ctx.dilation), (g_out,),
                              ctx.needs_input_grad[:8])
        return (*grads, None, None, None)


def dac_resunit(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int, *,
                precision: str = "exact", snake_poly: bool = False,
                packed=None):
    """The fused unit: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns ``[B, C, T]`` of ``x``'s dtype. ``precision``
    "exact" takes float32; "default" (one bf16 pass) float32 or bfloat16;
    the weights and α have ``x``'s dtype. On the card the kernel takes
    contiguous tensors, ``C <= 256`` and, in the default form,
    ``128 + 6·dilation <= 256``; anything else raises. ``packed`` is
    :func:`pack_resunit_weights` of ``(w7, w1)`` for ``precision``; without
    it the kernel's layout is built for this call. The CPU path ignores it.
    The exact sin form is differentiable on both devices (:class:`_Unit`):
    the backward recomputes through the plain version and launches no
    kernel; the other forms raise on a gradient."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    _check_form(x, precision)
    return _Unit.apply(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed,
                       precision, snake_poly)


# kernel launches in this process by form (their sum: every launch)
dac_resunit.launches_by_form = dict.fromkeys(FORMS, 0)


def dac_resunit_stages(x, w7, b7, alpha1, w1, b1, alpha2, dilation: int, *,
                       snake_poly: bool = False, packed=None):
    """The default form with its last rounding point written out: returns
    ``(out, h2)``, ``h2`` the bf16 input of the 1×1 conv. For CUDA tensors
    the kernel writes both in one launch; for CPU tensors they are
    :func:`default_head` and :func:`default_tail`. A check can then hold the
    kernel to its plain version one rounding point at a time: ``h2``
    against :func:`default_head`, ``out`` against :func:`default_tail` of
    the kernel's own ``h2``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    with torch.no_grad():
        if x.device.type == "cpu":
            h2 = default_head(x, w7, b7, alpha1, alpha2, dilation,
                              snake_poly)
            return default_tail(x, h2, w1, b1), h2
        _check(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed,
               "default")
        h2 = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
        out = _launch(x, w7, b7, alpha1, w1, b1, alpha2, dilation, packed,
                      "default", snake_poly, h2=h2)
    return out, h2


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def default_errors(out, h2, x, w7, b7, alpha1, w1, b1, alpha2,
                   dilation: int, snake_poly: bool = False) -> dict:
    """The default form's kernel (``out``, ``h2`` from
    :func:`dac_resunit_stages`) against its plain version, one rounding
    point at a time.

    Two correct implementations of a bf16 rounding point disagree wherever
    their fp32 sums, taken in different orders, straddle a rounding
    boundary: there one bf16 ulp apart, and that ulp reaches every output
    the element feeds (on DAC's shapes about 1e-4 of h2's elements, each
    moving an output by up to 6e-4 of max|out|). So the kernel is held to:

    * h2 (the 1×1 conv's bf16 input) within one bf16 ulp of
      :func:`default_head`'s, elementwise, or 1e-4 · max|h2| where that is
      larger (sums that cancel to near zero);
    * ``out`` against :func:`default_tail` of the kernel's own h2: fp32
      within 1e-4 · max|tail|; bf16 within one bf16 ulp, plus 1e-5 ·
      max|tail| for fp32 sums in another order near zero.

    Returns the errors, their limits, ``ok``, and for information the
    share of h2 elements that differ and max|out − plain| end to end."""
    with torch.no_grad():
        h2_plain = default_head(x, w7, b7, alpha1, alpha2, dilation,
                                snake_poly)
        tail = default_tail(x, h2, w1, b1)
        hp = h2_plain.float()
        h2_lim = torch.maximum(_bf16_ulp(hp), 1e-4 * hp.abs().max())
        h2_diff = (h2.float() - hp).abs()
        scale = float(tail.float().abs().max())
        diff = (out.float() - tail.float()).abs()
        if out.dtype == torch.bfloat16:
            out_lim = _bf16_ulp(tail) + 1e-5 * scale
            out_ratio = float((diff / out_lim).max())
        else:
            out_ratio = float(diff.max()) / (1e-4 * scale)
        plain = default_tail(x, h2_plain, w1, b1)
        res = {"h2_ratio": float((h2_diff / h2_lim).max()),
               "h2_differ": float((h2_diff > 0).float().mean()),
               "tail_err": float(diff.max()), "tail_ratio": out_ratio,
               "max_abs_err": float((out.float() - plain.float()).abs()
                                    .max()),
               "scale": scale}
    res["ok"] = res["h2_ratio"] <= 1.0 and res["tail_ratio"] <= 1.0
    return res


def dac_resunit_info(C: int, dilation: int, precision: str = "exact",
                     snake_poly: bool = False,
                     dtype=torch.float32) -> dict:
    """The occupancy of the kernel instance that a form launches for a unit
    of C channels at ``dilation`` on the current card: registers and local
    (spill) bytes a thread, shared bytes a block and resident blocks an SM
    (CUDA's attribute and occupancy queries)."""
    lib = _lib()
    form = (int(precision == "default") | 2 * int(snake_poly)
            | 4 * int(dtype == torch.bfloat16))
    regs, local, smem, blocks = _I(), _I(), _I(), _I()
    err = lib.dac_resunit_info(C, dilation, form, ctypes.byref(regs),
                               ctypes.byref(local), ctypes.byref(smem),
                               ctypes.byref(blocks))
    if err:
        raise RuntimeError("dac_resunit_info failed: "
                           + lib.dac_resunit_error_string(err).decode())
    return {"regs": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value, "blocks_per_sm": blocks.value}
