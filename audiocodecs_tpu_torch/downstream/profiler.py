"""Model profiler: latency, FLOPs and memory over a sweep of input lengths.

Counterpart of ``audiocodecs_tpu/downstream/profiler.py`` (reference
``downstream/profiler.py:52-203``: wall time with CUDA sync, peak CUDA
memory, GMACs from a FLOP counter), with the same keys:

* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one
  call, plus the FLOPs of every hand-written kernel the call launched: a
  kernel runs through ctypes, out of the counter's sight, so each wrapper
  (``ops/lstm_recurrence.py``, ``ops/seanet_resblock.py``,
  ``ops/dac_resunit.py``) tallies its launches' FLOPs by a formula equal to
  what the counter records for its plain version. The card's count is then
  the CPU's (where the plain versions run under the counter);
* ``bytes_accessed_gb``: the bytes each dispatched operator reads and
  writes (its tensor arguments and outputs once each; views move nothing),
  plus each kernel's tensors read or written once;
* latency: ``time_s`` (median of per-call times, each closed by a
  synchronise) and ``time_pipelined_s`` (four calls back to back and one
  synchronise, over four), on the card by ``torch.cuda.Event`` pairs, on
  the CPU by ``perf_counter``;
* memory: the argument and output bytes, and on the card the peak
  allocated over a call (``torch.cuda.max_memory_allocated``) and its
  excess over what was held before and the output (``temp_bytes``); the
  CPU has no peak, ``None``.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["profile_fn", "profile_codec", "param_count", "format_report",
           "kernel_tally"]


def param_count(module: torch.nn.Module) -> int:
    """Elements of ``module``'s state dict (weights and buffers)."""
    return sum(t.numel() for t in module.state_dict().values())


def _kernel_wrappers():
    from audiocodecs_tpu_torch.ops.dac_resunit import dac_resunit
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        seanet_resblock,
        seanet_resblock_packed,
    )

    return (lstm_recurrence, seanet_resblock, seanet_resblock_packed,
            dac_resunit)


def kernel_tally() -> tuple[int, int]:
    """(FLOPs, bytes) of every kernel launch in this process so far."""
    wrappers = _kernel_wrappers()
    return (sum(w.flops for w in wrappers), sum(w.bytes for w in wrappers))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every non-view operator's tensor arguments and
    outputs."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _device_of(args) -> torch.device:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _span(fn, args, k: int, dev: torch.device) -> float:
    """Seconds of ``k`` calls back to back, closed by one synchronise."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(k):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _memory(fn, args, dev: torch.device) -> dict:
    mem = {"argument_bytes": _nbytes(args)}
    if dev.type != "cuda":
        mem["output_bytes"] = _nbytes(fn(*args))
        mem["temp_bytes"] = mem["peak_bytes_in_use"] = None
        return mem
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    mem["output_bytes"] = _nbytes(out)
    mem["temp_bytes"] = max(peak - held - mem["output_bytes"], 0)
    mem["peak_bytes_in_use"] = int(peak)
    return mem


def profile_fn(fn: Callable, args: tuple, *, runs: int = 5,
               warmups: int = 2) -> dict:
    """Profile ``fn(*args)`` on its arguments' device.

    Two latency estimates, as the reference's: ``time_s`` (per call, each
    closed by a synchronise; its median, and ``time_min_s`` the least) and
    ``time_pipelined_s`` (four calls, one synchronise, over four; the
    median of ``max(2, runs // 2)``). ``gflops`` and ``bytes_accessed_gb``
    come from one counted call (the module docstring), ``gmacs`` is half
    the FLOPs."""
    dev = _device_of(args)
    for _ in range(warmups):
        _span(fn, args, 1, dev)
    flops0, bytes0 = kernel_tally()
    with FlopCounterMode(display=False) as counter, _BytesMode() as moved:
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    flops1, bytes1 = kernel_tally()
    flops = counter.get_total_flops() + flops1 - flops0
    nbytes = moved.total + bytes1 - bytes0
    times = [_span(fn, args, 1, dev) for _ in range(runs)]
    times2 = [_span(fn, args, 4, dev) / 4 for _ in range(max(2, runs // 2))]
    return {
        "time_s": float(np.median(times)),
        "time_min_s": float(np.min(times)),
        "time_pipelined_s": float(np.median(times2)),
        "gflops": flops / 1e9,
        "gmacs": flops / 2e9,
        "bytes_accessed_gb": nbytes / 1e9,
        "memory": _memory(fn, args, dev),
    }


def profile_codec(codec, seconds: Sequence[float] = (1, 2, 4, 8, 16, 32),
                  batch: int = 1, runs: int = 5, warmups: int = 2) -> dict:
    """Sweep input durations through encode + decode on the codec's device
    (the card when it has none; the reference profiles the same 1-32 s
    sweep, ``test_sr.py:379-391``):
    ``[batch, sample_rate · sec]`` of seeded noise through the model's
    ``_sig_to_toks`` then ``_toks_to_sig`` (no resampling, as the
    reference's), in inference mode with TF32 off."""
    from audiocodecs_tpu_torch.codec import resolve_device
    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    dev = resolve_device(codec.device)

    def roundtrip(sig):
        with torch.inference_mode(), exact_fp32():
            return codec._toks_to_sig(codec._sig_to_toks(sig, None), None)

    results = {}
    sr = codec.sample_rate
    for sec in seconds:
        T = int(sr * sec)
        sig = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (batch, T)).astype(np.float32)).to(dev)
        r = profile_fn(roundtrip, (sig,), runs=runs, warmups=warmups)
        r["rtf"] = batch * sec / r["time_s"]
        results[f"{sec}s"] = r
    results["params_m"] = param_count(codec) / 1e6
    return results


def format_report(results: dict) -> str:
    lines = [f"{'input':>8} {'time(s)':>10} {'GMACs':>10} {'RTF':>10}"]
    for k, v in results.items():
        if not isinstance(v, dict):
            continue
        lines.append(
            f"{k:>8} {v['time_s']:>10.4f} {v['gmacs']:>10.2f} {v['rtf']:>10.1f}"
        )
    if "params_m" in results:
        lines.append(f"params: {results['params_m']:.2f} M")
    return "\n".join(lines)
