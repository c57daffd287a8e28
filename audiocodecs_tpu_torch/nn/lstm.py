"""Multi-layer LSTM matching PyTorch ``nn.LSTM`` numerics (gate order i,f,g,o).

Counterpart of ``audiocodecs_tpu/nn/lstm.py``. The input projection for the
whole sequence is one ``torch.matmul`` (TF32 off), written time-major; the
recurrence always goes through :func:`..ops.lstm_recurrence.lstm_recurrence`,
which launches the CUDA kernel for CUDA tensors and runs the plain loop for
CPU tensors. On the card a width the kernel does not take (``H % 32 != 0``
or ``H > 1536``) raises rather than running the plain loop.

Params per layer: ``{"w_ih": [Cin, 4H], "w_hh": [H, 4H], "b": [4H]}`` with
the two PyTorch biases summed, as in the reference package. A bidirectional
layer holds one such dict per direction (``{"fwd": …, "bwd": …}``).
"""

from __future__ import annotations

import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence

__all__ = ["BiLSTM", "LSTM", "LSTMLayer", "bilstm", "init_bilstm_params",
           "init_lstm_params", "lstm", "lstm_cell_step"]


def _layer(x: torch.Tensor, p, h0=None, c0=None):
    """One LSTM layer. ``x``: [B, T, Cin] → ([B, T, H], (h_T, c_T))."""
    B, T, cin = x.shape
    H = p["w_hh"].shape[0]
    # one [T·B, Cin] x [Cin, 4H] product: torch.matmul folds a 3-D operand
    # into one GEMM only if its leading dims are contiguous or an operand
    # requires grad, and otherwise runs a batched product, several times
    # slower on the card
    with exact_fp32():
        gates_x = torch.matmul(x.transpose(0, 1).reshape(T * B, cin),
                               p["w_ih"]) + p["b"]
    h = x.new_zeros((B, H)) if h0 is None else h0.contiguous()
    c = x.new_zeros((B, H)) if c0 is None else c0.contiguous()
    ys, h, c = lstm_recurrence(gates_x.view(T, B, 4 * H),
                               p["w_hh"].contiguous(), h, c)
    return ys.transpose(0, 1), (h, c)


def lstm_cell_step(gates_x, h, c, w_hh):
    """One recurrence step. ``gates_x``: [B, 4H] (input projection + bias)."""
    _, h, c = lstm_recurrence(gates_x[None].contiguous(), w_hh.contiguous(),
                              h.contiguous(), c.contiguous())
    return h, c


def lstm(x: torch.Tensor, params, state=None):
    """Stacked LSTM. ``x``: [B, T, C] → ([B, T, H], per-layer (h, c)).

    ``state`` is an optional list of per-layer ``(h, c)`` carries.
    """
    new_state = []
    for li, p in enumerate(params):
        h0c0 = state[li] if state is not None else (None, None)
        x, hc = _layer(x, p, *h0c0)
        new_state.append(hc)
    return x, new_state


def bilstm(x: torch.Tensor, params) -> torch.Tensor:
    """Bidirectional stacked LSTM. ``x``: [B, T, C] → [B, T, 2H].

    ``params``: per-layer ``{"fwd": {...}, "bwd": {...}}`` (PyTorch's
    ``bidirectional=True`` layout: layer l > 0 reads 2H inputs). The
    backward direction runs on ``x`` flipped in time and its output is
    flipped back. The two directions run one after the other on the
    caller's stream: each recurrence kernel is a cooperative launch whose
    blocks wait on each other, so two on separate streams could share the
    card's SMs and stall each other.
    """
    for p in params:
        fwd, _ = _layer(x, p["fwd"])
        bwd, _ = _layer(torch.flip(x, dims=(1,)), p["bwd"])
        x = torch.cat([fwd, torch.flip(bwd, dims=(1,))], dim=-1)
    return x


class LSTMLayer(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.b = nn.Parameter(torch.empty(4 * hidden_size))

    def params(self) -> dict:
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}


class LSTM(nn.ModuleList):
    """A stack of :class:`LSTMLayer` (state-dict keys ``<i>.w_ih`` …)."""

    def __init__(self, num_layers: int, input_size: int, hidden_size: int):
        super().__init__(
            LSTMLayer(input_size if li == 0 else hidden_size, hidden_size)
            for li in range(num_layers))

    def forward(self, x: torch.Tensor, state=None):
        return lstm(x, [layer.params() for layer in self], state)


class BiLSTMLayer(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.fwd = LSTMLayer(input_size, hidden_size)
        self.bwd = LSTMLayer(input_size, hidden_size)

    def params(self) -> dict:
        return {"fwd": self.fwd.params(), "bwd": self.bwd.params()}


class BiLSTM(nn.ModuleList):
    """A stack of :class:`BiLSTMLayer` (state-dict keys ``<i>.fwd.w_ih`` …);
    ``forward``: [B, T, C] → [B, T, 2H]."""

    def __init__(self, num_layers: int, input_size: int, hidden_size: int):
        super().__init__(
            BiLSTMLayer(input_size if li == 0 else 2 * hidden_size,
                        hidden_size)
            for li in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilstm(x, [layer.params() for layer in self])


def init_bilstm_params(generator: torch.Generator, num_layers: int,
                       input_size: int, hidden_size: int) -> list:
    """Per-layer ``{"fwd": …, "bwd": …}`` params in
    :func:`init_lstm_params`'s distribution."""
    return [
        {d: init_lstm_params(generator, 1,
                             input_size if li == 0 else 2 * hidden_size,
                             hidden_size)[0]
         for d in ("fwd", "bwd")}
        for li in range(num_layers)]


def init_lstm_params(generator: torch.Generator, num_layers: int,
                     input_size: int, hidden_size: int) -> list:
    """Per-layer params, uniform in ±1/sqrt(H) with zero bias (the
    reference package's init; the draws differ from ``jax.random``'s)."""
    s = 1.0 / hidden_size ** 0.5
    params = []
    for li in range(num_layers):
        cin = input_size if li == 0 else hidden_size

        def uniform(*shape):
            return (torch.rand(shape, generator=generator) * 2 - 1) * s

        params.append({
            "w_ih": uniform(cin, 4 * hidden_size),
            "w_hh": uniform(hidden_size, 4 * hidden_size),
            "b": torch.zeros(4 * hidden_size),
        })
    return params
