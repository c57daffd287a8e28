"""The kernels' gradient rule: recompute through the plain version.

Each kernel's ``torch.autograd.Function`` runs the kernel (or, for CPU
tensors, its plain version) in the forward and saves only its inputs. The
backward calls :func:`recompute_vjp`: it runs the plain PyTorch version
again under autograd and returns its vector-Jacobian product. This is the
JAX package's rule for the LSTM kernel
(``audiocodecs_tpu/ops/lstm_pallas.py:97-117``, a ``custom_vjp`` whose
backward is XLA's VJP of ``_scan_reference``), applied to every kernel:
the backward launches no kernel of this package.
"""

from __future__ import annotations

import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["recompute_vjp"]


def recompute_vjp(plain, name: str, inputs, grad_outputs, needs_input_grad):
    """Gradients of ``plain(*inputs)`` for the inputs that need one.

    ``inputs`` are the forward's arguments (tensors or plain values, in
    order); ``grad_outputs`` the output gradients, ``None`` for an output
    that got none (the Functions do not materialize them, so an unused
    ``h_T`` costs nothing); ``needs_input_grad`` the Function's flags.
    Returns one entry an input: its gradient, or ``None``. The recompute and
    its VJP run with TF32 off and inside a profiler range ``name``."""
    with torch.profiler.record_function(name), torch.enable_grad(), \
            exact_fp32():
        args = [t.detach().requires_grad_(need)
                if isinstance(t, torch.Tensor) else t
                for t, need in zip(inputs, needs_input_grad)]
        outs = plain(*args)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wrt = [a for a, need in zip(args, needs_input_grad) if need]
        if not pairs or not wrt:
            return (None,) * len(args)
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True))
    return tuple(next(grads) if need else None for need in needs_input_grad)
