"""Core 1-D primitives in PyTorch's ``[B, C, T]`` layout.

Counterpart of ``audiocodecs_tpu/nn/layers.py`` (which is channel-last and
stores conv weights as ``[K, Cin, Cout]``). Here conv weights are PyTorch's
``[Cout, Cin, K]`` and transposed-conv weights ``[Cin, Cout, K]``; the
weight bridge (:mod:`audiocodecs_tpu_torch.params`) converts once.

Padding reproduces the reference codecs' conv framing (causal or asymmetric
left padding plus right "extra" padding to a whole number of frames); the
lengths are Python ints computed from the input shape.

The convs are library calls (``F.conv1d``/``F.conv_transpose1d``), as the
reference leaves them to XLA outside any Pallas kernel. They run in exact
fp32: cuDNN's TF32 default keeps ~3 decimal digits and flips argmin-marginal
tokens (:func:`exact_fp32`).

:class:`DecodeForm` is the counterpart of the reference's numeric switches
(``act_dtype``, ``conv_role`` and ``conv_precision``): how a conv stack
computes, given to a model when it is built instead of read from the
environment.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "conv1d",
    "conv_transpose1d",
    "pad1d",
    "extra_padding_for_frames",
    "causal_conv1d",
    "streaming_conv_frames",
    "elu",
    "unit_norm",
    "exact_fp32",
    "deterministic_convs",
    "Conv1d",
    "Conv2d",
    "ConvTranspose1d",
    "DecodeForm",
    "param_as",
    "PRECISIONS",
    "init_conv",
]

PRECISIONS = ("exact", "default")  # a form's conv precision


class _Scoped:
    """Process-wide backend switches set to fixed values inside ``with``.

    The switches are process-wide, so concurrent callers share one count:
    the first to enter saves the caller's settings and sets them, the last
    to leave restores them."""

    def __init__(self, *switches):
        self._switches = switches  # (owner, attribute, value inside)
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = [getattr(o, a) for o, a, _ in self._switches]
                for o, a, v in self._switches:
                    setattr(o, a, v)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    for (o, a, _), v in zip(self._switches, self._saved):
                        setattr(o, a, v)


# ``with exact_fp32():`` runs cuDNN convs and cuBLAS matmuls in full fp32
# (TF32 off)
exact_fp32 = _Scoped((torch.backends.cudnn, "allow_tf32", False),
                     (torch.backends.cuda.matmul, "allow_tf32", False))
# ``with deterministic_convs():`` keeps cuDNN to deterministic algorithms:
# its transposed convs (backward-data) otherwise may sum with atomics, and
# two runs on the same input part in the last bits
deterministic_convs = _Scoped((torch.backends.cudnn, "deterministic", True))


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def unit_norm(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """``x · rsqrt(Σx² + eps)`` along ``dim``."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


class Conv1d(nn.Module):
    """Weights only: ``w`` [Cout, Cin, K], ``b`` [Cout] (``b`` is None with
    ``bias=False``). The weight bridge converts the reference's
    ``[K, Cin, Cout]`` for modules of this class."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, k))
        self.b = nn.Parameter(torch.empty(cout)) if bias else None


class Conv2d(nn.Module):
    """Weights only: ``w`` [Cout, Cin, kh, kw], ``b`` [Cout]. The weight
    bridge converts the reference's ``[kh, kw, Cin, Cout]`` (HWIO) for
    modules of this class."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.b = nn.Parameter(torch.empty(cout))


class ConvTranspose1d(nn.Module):
    """Weights only: ``w`` [Cin, Cout/groups, K] (PyTorch's layout), ``b``
    [Cout] (None with ``bias=False``). The weight bridge unflips and
    regroups the reference's pre-flipped ``[K, Cin/groups, Cout]`` for
    modules of this class."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.groups = groups
        self.w = nn.Parameter(torch.empty(cin, cout // groups, k))
        self.b = nn.Parameter(torch.empty(cout)) if bias else None


def conv1d(x, w, b=None, *, stride: int = 1, dilation: int = 1,
           groups: int = 1):
    """Valid-padding conv. ``x``: [B, Cin, T], ``w``: [Cout, Cin/groups, K]."""
    with exact_fp32():
        return F.conv1d(x, w, b, stride=stride, dilation=dilation,
                        groups=groups)


def conv_transpose1d(x, w, b=None, *, stride: int = 1, groups: int = 1):
    """Full transposed conv (output length ``(T-1)*stride + K``).

    ``x``: [B, Cin, T]; ``w``: [Cin, Cout/groups, K], PyTorch's
    ``ConvTranspose1d`` layout (not pre-flipped).
    """
    with exact_fp32():
        return F.conv_transpose1d(x, w, b, stride=stride, groups=groups)


def pad1d(x: torch.Tensor, left: int, right: int,
          mode: str = "constant") -> torch.Tensor:
    """Pad the time axis of ``[B, C, T]``.

    Reflect mode zero-extends a signal shorter than the pad before
    reflecting, then trims (HF ``EncodecConv1d._pad1d`` behaviour);
    ``F.pad`` alone raises there.
    """
    if left == 0 and right == 0:
        return x
    if mode in ("constant", "zero"):
        return F.pad(x, (left, right))
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(left, right)
        extra = 0
        if length <= max_pad:
            extra = max_pad - length + 1
            x = F.pad(x, (0, extra))
        y = F.pad(x, (left, right), mode="reflect")
        return y[..., : y.shape[-1] - extra] if extra else y
    if mode == "replicate":
        return F.pad(x, (left, right), mode="replicate")
    raise ValueError(f"unknown pad mode: {mode}")


def extra_padding_for_frames(length: int, kernel_size: int, stride: int,
                             padding_total: int) -> int:
    """Right padding so the conv covers a whole number of frames."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + kernel_size - padding_total
    return max(0, ideal - length)


def frame_pad(x, k: int, *, stride: int = 1, dilation: int = 1,
              causal: bool = True, pad_mode: str = "reflect"):
    """The padding of the reference codecs' framed conv of ``k`` taps:
    causal-left (or asymmetric) padding plus right extra-padding to a whole
    frame count."""
    eff_k = (k - 1) * dilation + 1
    padding_total = eff_k - stride
    extra = extra_padding_for_frames(x.shape[-1], eff_k, stride, padding_total)
    if causal:
        return pad1d(x, padding_total, extra, mode=pad_mode)
    right = padding_total // 2
    return pad1d(x, padding_total - right, right + extra, mode=pad_mode)


def causal_conv1d(x, w, b=None, *, stride: int = 1, dilation: int = 1,
                  causal: bool = True, pad_mode: str = "reflect"):
    """Conv with the reference codecs' framing (:func:`frame_pad`)."""
    x = frame_pad(x, w.shape[-1], stride=stride, dilation=dilation,
                  causal=causal, pad_mode=pad_mode)
    return conv1d(x, w, b, stride=stride, dilation=dilation)


def streaming_conv_frames(length: int, kernel_size: int, stride: int) -> int:
    """Number of output frames for a causal conv over ``length`` samples."""
    padding_total = kernel_size - stride
    extra = extra_padding_for_frames(length, kernel_size, stride, padding_total)
    return (length + padding_total + extra - kernel_size) // stride + 1


def init_conv(out: dict, generator: torch.Generator, name: str, cin: int,
              cout: int, k: int, *, transposed: bool = False,
              groups: int = 1, bias: bool = True, gain: float = 1.0) -> None:
    """The reference packages' conv init into the flat state dict ``out``
    under ``name``: weights N(0, 1) · gain · (k · cin / groups)^-½ in the
    port's layout (:class:`Conv1d`'s, or with ``transposed``
    :class:`ConvTranspose1d`'s), zero biases (none with ``bias=False``)."""
    shape = ((cin, cout // groups, k) if transposed
             else (cout, cin // groups, k))
    out[f"{name}.w"] = (torch.randn(shape, generator=generator)
                        * gain * (k * cin // groups) ** -0.5)
    if bias:
        out[f"{name}.b"] = torch.zeros(cout)


def _cached(module: nn.Module, name: str, tag, make, params=None):
    """``make`` of ``params`` (by default ``module``'s parameter ``name``)
    detached, kept outside the state dict under ``name``: built once and
    again only when ``tag`` or a parameter's (device, data_ptr, version)
    changes (a move, ``load_state_dict`` or an optimizer's step)."""
    params = (getattr(module, name),) if params is None else params
    key = (tag, *((p.device, p.data_ptr(), p._version) for p in params))
    cache = module.__dict__.setdefault("_form_cache", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make(*(p.detach() for p in params)))
        cache[name] = hit
    return hit[1]


def param_as(module: nn.Module, name: str, dtype: torch.dtype):
    """``module.<name>`` in ``dtype``: itself in float32, else a cast copy
    built once (and again only when the parameter changes)."""
    if dtype == torch.float32:
        return getattr(module, name)
    return _cached(module, name, dtype, lambda t: t.to(dtype))


@dataclasses.dataclass(frozen=True)
class DecodeForm:
    """How a conv stack computes: a serving tier (the reference's stacks
    under its environment switches, ``audiocodecs_tpu/nn/layers.py:39-107``).

    * ``dtype``: the activations' dtype, float32 or bfloat16
      (``ACX_ACT_DTYPE=decoder-bfloat16``). The input and the weights are
      cast to it (each weight once, again only when it changes); bf16 convs
      run in bf16 (cuDNN on the card), and need ``precision="default"``.
    * ``precision``: ``"exact"`` (fp32, TF32 off) or ``"default"``, one
      bf16 pass: with fp32 activations every conv takes bf16-rounded
      operands and sums in fp32 (``ACX_DEC_CONV_PRECISION=default``, or
      ``ACX_CONV_PRECISION=default`` for an encoder).
    * ``snake_poly``: the polynomial snake (``ACX_SNAKE_APPROX=1``).

    The fused kernels take the same form (``precision``, the operands'
    dtype, and B4's ``snake_poly``). A model's stack casts its output back
    to float32."""

    dtype: torch.dtype = torch.float32
    precision: str = "exact"
    snake_poly: bool = False

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"decode_dtype must be float32 or bfloat16, "
                             f"got {self.dtype}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"decode_precision must be one of {PRECISIONS},"
                             f" got {self.precision!r}")
        if self.dtype == torch.bfloat16 and self.precision != "default":
            raise ValueError("bf16 activations run one bf16 pass: "
                             "decode_precision='default'")

    @property
    def exact(self) -> bool:
        return self == DecodeForm()

    @property
    def one_pass(self) -> bool:
        """fp32 activations at one bf16 pass: every product takes
        bf16-rounded operands and sums in fp32."""
        return self.dtype == torch.float32 and self.precision == "default"

    def ignoring_dtype(self) -> "DecodeForm":
        """The form of a stack that reads no activation dtype, only the
        decoder's precision (the zoo's transformer and conv decoders
        inside the reference's ``conv_role("decoder")``): this form with
        fp32 activations; the exact form for bf16 activations, whose tier
        (``ACX_ACT_DTYPE=decoder-bfloat16``) sets no decoder precision.
        The reference's bf16 activations together with
        ``ACX_DEC_CONV_PRECISION=default`` have no name among the forms."""
        return self if self.dtype == torch.float32 else DecodeForm()

    def rounded(self, module: nn.Module, name: str) -> torch.Tensor:
        """``module.<name>`` as an operand of this form's products: rounded
        to bf16 (kept as fp32, built once and again only when it changes)
        in the one-pass form, else itself."""
        if not self.one_pass:
            return getattr(module, name)
        return _cached(module, name, "rounded",
                       lambda t: t.to(torch.bfloat16).float())

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as an operand of this form's products: rounded to
        bf16 in the one-pass form, else itself."""
        return x.to(torch.bfloat16).float() if self.one_pass else x

    def matmul(self, x: torch.Tensor, module: nn.Module,
               name: str) -> torch.Tensor:
        """``x @ module.<name>`` in this form: full fp32 (TF32 off), on
        bf16-rounded operands in the one-pass form."""
        w = self.rounded(module, name)
        with exact_fp32():
            return torch.matmul(self.operand(x), w)

    def param(self, module: nn.Module, name: str) -> torch.Tensor:
        """``module.<name>`` (a weight, bias or α) in the activations'
        dtype."""
        return param_as(module, name, self.dtype)

    def _conv(self, fn, x, conv, **kw):
        if self.one_pass:
            w, x = self.rounded(conv, "w"), self.operand(x)
        else:
            w = self.param(conv, "w")
        b = None if conv.b is None else self.param(conv, "b")
        if self.dtype == torch.float32:
            return fn(x, w, b, **kw)
        # bf16: the conv's output is rounded, then the bias added in bf16,
        # as the reference's conv1d does
        y = fn(x, w, None, **kw)
        return y if b is None else y + b[:, None]

    def conv1d(self, x, conv: Conv1d, *, stride: int = 1, dilation: int = 1,
               pad: int = 0, groups: int = 1):
        """Symmetric zero pad, then a valid conv in this form."""
        if pad:
            x = F.pad(x, (pad, pad))
        return self._conv(conv1d, x, conv, stride=stride, dilation=dilation,
                          groups=groups)

    def causal_conv1d(self, x, conv: Conv1d, *, stride: int = 1,
                      dilation: int = 1, causal: bool = True,
                      pad_mode: str = "reflect"):
        """The reference codecs' framed conv (:func:`causal_conv1d`) in
        this form."""
        x = frame_pad(x, conv.w.shape[-1], stride=stride, dilation=dilation,
                      causal=causal, pad_mode=pad_mode)
        return self._conv(conv1d, x, conv, stride=stride, dilation=dilation)

    def conv_transpose1d(self, x, conv: ConvTranspose1d, *, stride: int):
        """Full transposed conv in this form."""
        return self._conv(conv_transpose1d, x, conv, stride=stride)
