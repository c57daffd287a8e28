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
"""

from __future__ import annotations

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
    "Conv1d",
    "ConvTranspose1d",
]


class _ExactFP32:
    """TF32 off for cuDNN convs and cuBLAS matmuls inside ``with``.

    The TF32 switches are process-wide, so concurrent callers share one
    count: the first to enter saves the caller's settings and turns TF32
    off, the last to leave restores them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextmanager
    def __call__(self):
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        with self._lock:
            if self._depth == 0:
                self._saved = cudnn.allow_tf32, matmul.allow_tf32
                cudnn.allow_tf32 = False
                matmul.allow_tf32 = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    cudnn.allow_tf32, matmul.allow_tf32 = self._saved


# ``with exact_fp32():`` runs cuDNN convs and cuBLAS matmuls in full fp32
exact_fp32 = _ExactFP32()


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


def causal_conv1d(x, w, b=None, *, stride: int = 1, dilation: int = 1,
                  causal: bool = True, pad_mode: str = "reflect"):
    """Conv with the reference codecs' framing: causal-left (or asymmetric)
    padding plus right extra-padding to a whole frame count."""
    k = w.shape[-1]
    eff_k = (k - 1) * dilation + 1
    padding_total = eff_k - stride
    extra = extra_padding_for_frames(x.shape[-1], eff_k, stride, padding_total)
    if causal:
        x = pad1d(x, padding_total, extra, mode=pad_mode)
    else:
        right = padding_total // 2
        x = pad1d(x, padding_total - right, right + extra, mode=pad_mode)
    return conv1d(x, w, b, stride=stride, dilation=dilation)


def streaming_conv_frames(length: int, kernel_size: int, stride: int) -> int:
    """Number of output frames for a causal conv over ``length`` samples."""
    padding_total = kernel_size - stride
    extra = extra_padding_for_frames(length, kernel_size, stride, padding_total)
    return (length + padding_total + extra - kernel_size) // stride + 1
