"""One LSTM layer's recurrence: CUDA kernel and its plain PyTorch version.

The kernel (``csrc/lstm_recurrence.cu``) replaces the TPU kernel
``audiocodecs_tpu/ops/lstm_pallas.py::lstm_layer_pallas``: a persistent
cooperative grid in which each block keeps its slice of ``w_hh`` on chip
and the time loop runs inside the kernel. Blocks hand ``h_t`` to each other
through an exchange of tagged ``{value, step}`` pairs in device memory,
with no grid barrier inside the loop. Up to H = 1024 a block owns 1-8
units and holds its slice of ``w_hh`` in registers; for 1024 < H <= 1536
(BigCodec's H = 1536, the TPU kernel's wide mode) a separate instance owns
12 units a block and holds its 295 KB slice half in registers, half in
shared memory. The source's header states its bound and design.

:func:`lstm_recurrence` launches the kernel for CUDA tensors and runs
:func:`lstm_recurrence_reference` for CPU tensors; there is no other path.
Its gradient recomputes through the plain version (:class:`_Recurrence`),
on both devices.
"""

from __future__ import annotations

import ctypes

import torch

from audiocodecs_tpu_torch.ops import _build
from audiocodecs_tpu_torch.ops._autograd import recompute_vjp

__all__ = ["handoff_us", "lstm_recurrence", "lstm_recurrence_flops",
           "lstm_recurrence_info", "lstm_recurrence_reference", "MAX_HIDDEN"]

MAX_HIDDEN = 1536  # the kernel keeps a [H, 4U] slice of w_hh per SM

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_cache: list = []
# (device index, H) -> (rows a launch takes, exchange bytes a row)
_plans: dict = {}


def _lib():
    if not _lib_cache:
        lib = _build.load("lstm_recurrence")
        lib.lstm_recurrence_f32.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.lstm_recurrence_f32.restype = _I
        lib.lstm_recurrence_max_batch.argtypes = [_I]
        lib.lstm_recurrence_max_batch.restype = _I
        lib.lstm_recurrence_exchange_row_bytes.argtypes = [_I]
        lib.lstm_recurrence_exchange_row_bytes.restype = ctypes.c_long
        lib.lstm_recurrence_info.argtypes = [_I] * 2 + [ctypes.POINTER(_I)] * 5
        lib.lstm_recurrence_info.restype = _I
        lib.lstm_handoff_probe.argtypes = [_P, _I, _P]
        lib.lstm_handoff_probe.restype = _I
        lib.lstm_recurrence_error_string.argtypes = [_I]
        lib.lstm_recurrence_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def lstm_recurrence_reference(gates_x: torch.Tensor, w_hh: torch.Tensor,
                              h0: torch.Tensor, c0: torch.Tensor):
    """Plain recurrence, the math of ``_scan_reference`` (time-major).

    ``gates_x``: [T, B, 4H] (input projection + bias, gate order i, f, g, o);
    ``w_hh``: [H, 4H]; ``h0``/``c0``: [B, H] → (ys [T, B, H], h_T, c_T).
    """
    H = w_hh.shape[0]
    h, c = h0, c0
    ys = []
    for gx in gates_x:
        gates = gx + torch.matmul(h, w_hh)
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    if not ys:
        return gates_x.new_empty((0,) + tuple(h0.shape)), h0, c0
    return torch.stack(ys), h, c


def lstm_recurrence_flops(T: int, B: int, H: int) -> int:
    """FLOPs of the recurrence over [T, B] at width H as
    ``torch.utils.flop_counter.FlopCounterMode`` counts its plain version:
    one [B, H] x [H, 4H] product a step."""
    return 2 * T * B * H * 4 * H


def _check(gates_x, w_hh, h0, c0):
    if gates_x.ndim != 3 or w_hh.ndim != 2:
        raise ValueError("gates_x must be [T, B, 4H] and w_hh [H, 4H]")
    T, B, H4 = gates_x.shape
    H = w_hh.shape[0]
    if T < 1 or B < 1:
        raise ValueError(f"empty recurrence: T={T}, B={B}")
    if H4 != 4 * H or tuple(w_hh.shape) != (H, 4 * H):
        raise ValueError(f"shape mismatch: gates_x {tuple(gates_x.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}")
    if H % 32 or H > MAX_HIDDEN:
        raise ValueError(f"kernel takes H % 32 == 0 and H <= {MAX_HIDDEN}, "
                         f"got H={H}")
    for name, t, shape in (("gates_x", gates_x, (T, B, H4)),
                           ("w_hh", w_hh, (H, H4)),
                           ("h0", h0, (B, H)), ("c0", c0, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.device != gates_x.device:
            raise ValueError(f"{name} is on {t.device}, gates_x on "
                             f"{gates_x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _plan(lib, dev: torch.device, H: int):
    """Rows one launch takes and exchange bytes a row at H on ``dev``
    (the current device), asked of the library once."""
    key = (dev.index, H)
    if key not in _plans:
        rows = lib.lstm_recurrence_max_batch(H)
        if rows < 1:
            raise RuntimeError(f"lstm_recurrence: no launch fits H={H}")
        _plans[key] = rows, lib.lstm_recurrence_exchange_row_bytes(H)
    return _plans[key]


def _launch(gates_x, w_hh, h0, c0):
    """The kernel on CUDA tensors: one launch a slice of at most ``rows``
    rows."""
    _check(gates_x, w_hh, h0, c0)
    T, B, _ = gates_x.shape
    H = w_hh.shape[0]
    dev = gates_x.device
    ys = torch.empty((T, B, H), device=dev, dtype=torch.float32)
    h_t = torch.empty((B, H), device=dev, dtype=torch.float32)
    c_t = torch.empty_like(h_t)
    lib = _lib()
    f32 = 4  # bytes
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, row_bytes = _plan(lib, dev, H)
        # the exchange, reused by every launch, each of which clears it
        # first; a single step exchanges nothing. The tensor stays bound
        # until every launch is enqueued, so the caching allocator cannot
        # hand its block to another allocation before the kernels run.
        xchg = xchg_ptr = None
        if T > 1:
            xchg = torch.empty(min(rows, B) * row_bytes, device=dev,
                               dtype=torch.uint8)
            xchg_ptr = xchg.data_ptr()
        for b0 in range(0, B, rows):
            nb = min(rows, B - b0)
            err = lib.lstm_recurrence_f32(
                gates_x.data_ptr() + f32 * b0 * 4 * H, w_hh.data_ptr(),
                h0.data_ptr() + f32 * b0 * H, c0.data_ptr() + f32 * b0 * H,
                ys.data_ptr() + f32 * b0 * H, h_t.data_ptr() + f32 * b0 * H,
                c_t.data_ptr() + f32 * b0 * H, xchg_ptr, T, nb, B, H, stream)
            if err:
                raise RuntimeError(
                    "lstm_recurrence kernel launch failed: "
                    + lib.lstm_recurrence_error_string(err).decode())
            lstm_recurrence.launches += 1
            by_h = lstm_recurrence.launches_by_hidden
            by_h[H] = by_h.get(H, 0) + 1
            lstm_recurrence.flops += lstm_recurrence_flops(T, nb, H)
            if H > 1024:
                lstm_recurrence.wide_launches += 1
    lstm_recurrence.bytes += sum(t.nbytes for t in (
        gates_x, w_hh, h0, c0, ys, h_t, c_t))
    return ys, h_t, c_t


class _Recurrence(torch.autograd.Function):
    """The recurrence with the JAX package's gradient rule
    (``audiocodecs_tpu/ops/lstm_pallas.py:97-117``): the forward launches
    the kernel (CUDA tensors) or runs the plain version (CPU tensors); the
    backward recomputes through :func:`lstm_recurrence_reference` and
    returns its VJP for ``gates_x``, ``w_hh``, ``h0`` and ``c0``."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, h0, c0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gates_x, w_hh, h0, c0)
        if gates_x.device.type == "cpu":
            return lstm_recurrence_reference(gates_x, w_hh, h0, c0)
        return _launch(gates_x, w_hh, h0, c0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ys, g_h, g_c):
        return recompute_vjp(lstm_recurrence_reference,
                             "lstm_recurrence.backward", ctx.saved_tensors,
                             (g_ys, g_h, g_c), ctx.needs_input_grad)


def lstm_recurrence(gates_x: torch.Tensor, w_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor):
    """Run one layer's recurrence: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same contract as
    :func:`lstm_recurrence_reference`; the kernel takes float32,
    ``H % 32 == 0`` and ``H <= 1536``. A batch larger than one launch
    takes (:func:`lstm_recurrence_info`'s ``max_batch``: 8 rows above
    H = 1024) runs as consecutive row slices, one launch each.
    Differentiable on both devices: the backward recomputes through the
    plain version (:class:`_Recurrence`) and launches no kernel."""
    if gates_x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {gates_x.device}")
    return _Recurrence.apply(gates_x, w_hh, h0, c0)


lstm_recurrence.launches = 0  # kernel launches in this process
lstm_recurrence.wide_launches = 0  # of them of the wide instance, H > 1024
lstm_recurrence.launches_by_hidden = {}  # of them by width: {H: launches}
# the launches' FLOPs, as the flop counter counts the plain version's (it
# does not see a kernel launched through ctypes)
lstm_recurrence.flops = 0
lstm_recurrence.bytes = 0  # their tensors' bytes, each read or written once


def lstm_recurrence_info(H: int, B: int) -> dict:
    """The kernel a launch of B rows at width H runs, on the current card:
    units a block, registers and local (spill) bytes a thread, shared bytes
    a block and resident blocks an SM (CUDA's attribute and occupancy
    queries), and the most rows one launch takes."""
    lib = _lib()
    out = [_I() for _ in range(5)]
    err = lib.lstm_recurrence_info(H, B, *[ctypes.byref(v) for v in out])
    if err:
        raise RuntimeError("lstm_recurrence_info failed: "
                           + lib.lstm_recurrence_error_string(err).decode())
    regs, local, smem, blocks, u = (v.value for v in out)
    return {"units": u, "regs": regs, "local_bytes": local,
            "smem_bytes": smem, "blocks_per_sm": blocks,
            "max_batch": lib.lstm_recurrence_max_batch(H)}


def handoff_us(iters: int = 20000) -> float:
    """One hand-off of a tagged pair from one SM to another through L2, as
    the kernel makes it every step, in microseconds on the current card:
    two blocks pass a pair back and forth ``iters`` times (CUDA events).
    T of these is the recurrence's latency floor."""
    lib = _lib()
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for n in (100, iters):  # the first run is a warm-up
        pair = torch.zeros(2, device="cuda", dtype=torch.int64)
        start.record()
        err = lib.lstm_handoff_probe(pair.data_ptr(), n, stream)
        end.record()
        if err:
            raise RuntimeError(
                "lstm_handoff_probe failed: "
                + lib.lstm_recurrence_error_string(err).decode())
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (2 * iters)
