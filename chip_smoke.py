#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``audiocodecs_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and no network; it imports nothing
of JAX or of ``audiocodecs_tpu``. Phases, each of which exits non-zero when
it fails:

1. card: name and power limit (``nvidia-smi``);
2. build: every kernel of the main path, one ``nvcc`` each, all at once,
   and beside it ``nvcc -Xptxas -v`` on the LSTM kernel (registers and
   spills of each of its instances);
3. kernel 1, the LSTM recurrence, against its plain version at the main
   path's shape (T=750, B=8, H=512), a ragged one, a batch split over
   several launches, H=1024, one step (T=1), SpeechTokenizer's 10 s LSTMs
   (T=500, H=1024, B=8 and 1), one EnCodec streaming chunk (T=6, B=8)
   and EnCodec-48k's layer over 88 windows (T=150, B=88, three launches,
   and its launch shapes B=32 and 24), and two pairs of launches back to
   back; timings at B and at B=1 (per step) at the main shape, H=1024,
   T=1, T=500, T=6 and T=150 (B=32, 24) (``time_lstm``: a call, the
   kernel's own device time, and at T=1 calls queued back to back) with
   each one's bound, the kernel's registers, spill and shared bytes;
   ``nn.LSTM`` beside the port's bidirectional layer (T=500, B=8, H=1024),
   beside one streaming chunk's call and beside the 48k layer (B=32, 24,
   88); and one inter-SM hand-off, the latency floor of a step;
4. kernel 2, the fused SEANet residual block, against its plain version at
   the main path's four (C, T) shapes (B=8), a ragged one and its widest
   tile (C=384), with timings of the kernel on weights packed once (as the
   model calls it), the time of one pack, the model's unfused cuDNN path,
   and the kernel's registers, spills, shared bytes and blocks an SM;
5. the packed SEANet block entry point (channel-last, zero causal pad),
   which launches kernel 2, against its plain version at EnCodec's two
   narrow widths and a ragged shape, with timings;
6. kernel 3, the fused DAC residual unit, against its plain version (which
   the model's unfused units run) at the DAC-44.1k decoder's six
   (C, T, dilation) shapes, ragged ones (C and T off the kernel's chunk
   and tile), the widest window and ones shorter than their padding, with
   timings of the kernel on weights packed once (as the model calls it),
   the time of one pack, and the kernel's registers, shared bytes and
   blocks an SM;
7. the EnCodec path as a small server: EnCodec-24 kHz, 8 codebooks, seeded
   random weights, three requests through ``sig_to_toks`` → ``toks_to_sig``
   with the kernel launches and kernel 2's weight packs counted, parity
   against the same weights on the CPU, then the warm roundtrip time, peak memory and the device time by
   kernel over one roundtrip (torch.profiler);
8. the DAC path the same way: DAC-44.1 kHz, 9 codebooks, two 10 s requests
   and one B = 2 ragged request, six kernel-3 launches a decode, the fused
   units' weights packed on the first decode only;
9. SpeechTokenizer-16 kHz the same way: two B = 8 x 10 s requests and one
   B = 1 ragged one, six kernel-1 launches a roundtrip (the encoder's
   bidirectional LSTM, 2 layers x 2 directions, and the decoder's 2
   layers), parity on the ragged request and two rows of the first;
10. EnCodec-24 kHz streaming: B = 8 x 10 s in 125 chunks of 6 frames
   (80 ms) through ``encode_chunk`` then ``decode_chunk``, four kernel-1
   launches a chunk, against the CPU path's stream on two rows, with the
   median and p90 chunk time and the streaming RTF;
11. Mimi-24 kHz, 8 codebooks: the batch path as in 9 (no kernel launches),
   then the first request streamed in one-frame chunks (80 ms) against the
   card's batch path, with the chunk times;
12. WavTokenizer-24 kHz as in 9 (B = 8 x 10 s): two kernel-1 and four
   kernel-2 launches a roundtrip (the encoder), the Vocos head (768 wide,
   12 blocks) on library calls, profiled alone too;
13. EnCodec-24 kHz with the Vocos head (K = 8, bandwidth id 2) the same
   way: two kernel-1 and four kernel-2 launches a roundtrip;
14. EnCodec-48 kHz chunked (1 s windows, 1 % overlap, normalized,
   non-causal): B = 8 x 10 s is 88 windows, twelve kernel-1 launches a
   roundtrip (32 rows a launch), no kernel 2; parity on a B = 1 x 2.97 s
   request (3 windows);
15. PAST-16 kHz as in 9: four kernel-1 and eight kernel-2 launches a
   roundtrip, then the first request streamed in 80 ms chunks (4 frames)
   as in 10;
16. EnCodec-24 kHz training at its published width (seeded random
   weights, 8 codebooks, EMA codebooks, the spectral term live from the
   second step, Adam at 3e-4 with betas (0.5, 0.9)): first each kernel's
   autograd Function (kernel forward, backward recomputed through the
   plain version) against the plain version's autograd on the card, and
   each kernel's forward against its plain version, at the training
   path's shapes; step 1 on a B = 2 x 1 s batch against the CPU path
   (losses, every gradient, tokens, the EMA codebooks); then eight steps on
   B = 8 x 1 s synthetic batches, four kernel-1 and eight kernel-2 launches
   a step, every encoder and decoder gradient finite and nonzero, the warm
   step's time, audio seconds trained a wall second, peak memory, and one
   profiled step taken apart by the step's own ranges: each part's time,
   the kernels each part launched (all in the forward, none in the
   backward) and the time of the kernels' recompute inside the backward.

The JSON line of every kernel's numbers (``{"kernels": [...]}``) and the
card line come before the last line, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks (NVIDIA data sheets): fp32 on CUDA cores and HBM rate.
_PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
# main path, ragged, a batch split over several launches, the kernel's
# widest H, one step (lstm_cell_step); SpeechTokenizer's 10 s LSTMs at B = 8
# and B = 1, one 80 ms chunk of EnCodec streaming; EnCodec-48k's 88 windows
# of 150 frames (launches of 32, 32 and 24 rows)
LSTM_SHAPES = [(750, 8, 512), (257, 3, 512), (40, 100, 512), (750, 8, 1024),
               (1, 8, 512), (500, 8, 1024), (500, 1, 1024), (6, 8, 512),
               (150, 32, 512), (150, 24, 512), (150, 88, 512)]
# each also timed at B = 1
LSTM_TIMED = [(750, 8, 512), (750, 8, 1024), (1, 8, 512), (500, 8, 1024),
              (6, 8, 512), (150, 32, 512), (150, 24, 512)]
RESBLOCK_SHAPES = [(8, 32, 240000), (8, 64, 120000), (8, 128, 30000),
                   (8, 256, 6000)]
# ragged (T off the 4-sample vectors) and the widest tile
RESBLOCK_EXTRA = [(3, 64, 1001), (2, 384, 4096)]
PACKED_SHAPES = [(8, 32, 240000), (8, 64, 120000)]  # (B, C, T)
PACKED_RAGGED = (3, 64, 1001)
# the DAC-44.1k decoder's fused units for B = 1 x 10 s: (B, C, T, dilation)
DAC_UNIT_SHAPES = [(1, 192, 220416, d) for d in (1, 3, 9)] + [
    (1, 96, 440832, d) for d in (1, 3, 9)]
# ragged; T < 6d; C and T off the chunk and the tile; the widest window
DAC_UNIT_EXTRA = [(3, 96, 1001, 9), (2, 8, 20, 9), (1, 200, 4099, 9),
                  (1, 256, 4097, 9)]
# the Functions' gradients at the training step's shapes: (T, B, H) for B1,
# (B, C, T) for B2 (EnCodec-24k's four blocks at B = 8 x 1 s) and B3, and
# (B, C, T, dilation) for B4
TRAIN_GRAD_LSTM = (75, 8, 512)
TRAIN_GRAD_BLOCKS = [(8, 32, 24000), (8, 64, 12000), (8, 128, 3000),
                     (8, 256, 600)]
TRAIN_GRAD_PACKED = (8, 32, 24000)
TRAIN_GRAD_UNIT = (1, 192, 22050, 1)
TRAIN_B, TRAIN_STEPS, TRAIN_TIMED = 8, 8, slice(2, 8)  # steps 3-8 timed


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return name, card, _PEAKS["pcie" if "PCIe" in name else "sxm"]


def phase_build():
    from audiocodecs_tpu_torch.ops import _build

    # ptxas's report on the LSTM kernels (registers, spills), beside the build
    cubin = _build.BUILD_DIR / "lstm_recurrence.cubin"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-cubin",
         "-Xptxas", "-v", "-o", str(cubin),
         str(_build.CSRC / "lstm_recurrence.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        secs = _build.build_all()
    except RuntimeError as e:
        ptxas.kill()
        fail(f"kernel build: {e}")
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s")
    out, _ = ptxas.communicate(timeout=600)
    if ptxas.returncode != 0:
        fail(f"nvcc -Xptxas -v failed:\n{out}")
    for line in ptxas_report(out):
        log(line)


def ptxas_report(out: str) -> list:
    """One line per kernel of ``nvcc -Xptxas -v``: its template arguments
    (units a block, k rows a thread), registers and spill bytes."""
    import re

    lines, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"(lstm_(?:recurrence|handoff_probe)_kernel)"
                          r"(ILi(\d+)ELi(\d+)E)?", m.group(1))
            name = t and t.group(1)
            if t and t.group(2):
                name += " U={} KP={}".format(*t.group(3, 4))
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"ptxas {name}: {regs.group(1) if regs else '?'} "
                         f"registers; {spill}")
            name = None
    return lines


def _lstm_inputs(torch, gen, T, B, H, dev):
    s = 1.0 / math.sqrt(H)
    gx = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dev)
    w_hh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * s).to(dev)
    h0 = (torch.randn(B, H, generator=gen) * 0.1).to(dev)
    c0 = (torch.randn(B, H, generator=gen) * 0.1).to(dev)
    return gx, w_hh, h0, c0


def _lstm_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def time_lstm(torch, ops, T, B, H) -> dict:
    """``ops.lstm_recurrence`` (``ops``: the ``lstm_recurrence`` module of
    the checkout under test) at (T, B, H) and at B = 1, on inputs seeded by
    the shape alone, so that two checkouts timed in turns see the same
    work. Each is first held against ``ops.lstm_recurrence_reference``
    (limit 1e-5 absolute). Then: ms a call (CUDA events around the call, so
    the host's launch path counts), the kernel's own device time a launch
    (torch.profiler, the host left out), and at T = 1 ms a call over 50
    calls queued back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    out = {"T": T, "B": B, "H": H, "max_abs_err": 0.0}
    for pre, b in (("", B), ("b1_", 1)):
        gen = torch.Generator().manual_seed(T * 100003 + b * 1009 + H)
        args = _lstm_inputs(torch, gen, T, b, H, "cuda")

        def call():
            return ops.lstm_recurrence(*args)

        with torch.inference_mode(), exact_fp32():
            err = _lstm_err(call(), ops.lstm_recurrence_reference(*args))
            if not err <= 1e-5:
                fail(f"lstm_recurrence disagrees with its plain version at "
                     f"T={T} B={b} H={H}: {err}")
            ms = cuda_ms(torch, call)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev_us = [_device_us(e) / e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "lstm_recurrence_kernel" in e.key]
            out.update({f"{pre}ms": ms, f"{pre}per_step_us": ms / T * 1e3,
                        f"{pre}device_us": dev_us[0] if dev_us else None})
            if T == 1:
                def queued():
                    for _ in range(50):
                        call()
                out[f"{pre}queued_ms"] = cuda_ms(torch, queued, reps=5) / 50
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def _lstm_times(e: dict) -> str:
    def one(pre):
        s = (f"kernel_ms={e[pre + 'ms']:.4f} "
             f"per_step_us={e[pre + 'per_step_us']:.3f} device_us="
             + ("not measured" if e[pre + "device_us"] is None
                else f"{e[pre + 'device_us']:.2f}"))
        if pre + "queued_ms" in e:
            s += f" queued_ms={e[pre + 'queued_ms']:.4f}"
        return s
    return f"{one('')}; at B=1: {one('b1_')}"


def phase_lstm(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.ops import lstm_recurrence as ops
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        handoff_us, lstm_recurrence, lstm_recurrence_info,
        lstm_recurrence_reference)

    gen = torch.Generator().manual_seed(1)
    dev = "cuda"
    worst, per_shape = 0.0, []

    def check(label, args):
        nonlocal worst
        with torch.inference_mode(), exact_fp32():
            got = lstm_recurrence(*args)
            want = lstm_recurrence_reference(*args)
            torch.cuda.synchronize()
        err = _lstm_err(got, want)
        log(f"lstm_recurrence {label}: max_abs_err={err:.3e}")
        if not err <= 1e-5:
            fail(f"lstm_recurrence disagrees with its plain version at "
                 f"{label}: {err}")
        worst = max(worst, err)

    for T, B, H in LSTM_SHAPES:
        args = _lstm_inputs(torch, gen, T, B, H, dev)
        check(f"T={T} B={B} H={H}", args)
        if (T, B, H) == LSTM_SHAPES[0]:
            main_args = args

    for T, B, H in LSTM_TIMED:
        entry = time_lstm(torch, ops, T, B, H)
        worst = max(worst, entry["max_abs_err"])
        info = lstm_recurrence_info(H, B)
        entry.update(info)
        entry["bound_ms"], entry["bound_by"] = _lstm_bound(T, B, H, peaks)
        entry["b1_bound_ms"] = _lstm_bound(T, 1, H, peaks)[0]
        log(f"lstm_recurrence T={T} B={B} H={H}: {_lstm_times(entry)}; "
            f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}), at "
            f"B=1 {entry['b1_bound_ms']:.4f}; {json.dumps(info)}")
        per_shape.append(entry)
    main = per_shape[0]
    row = _lstm_main_row(torch, gen, peaks, main_args, main["ms"],
                         main["b1_ms"])
    row.update(_lstm_library(torch, gen))

    # back to back on one stream, different inputs, the exchange's memory
    # reused: at T = 2 a tag left by the first launch is the one the second
    # waits for at its last step, so only the kernel's clear keeps it right
    for T, B, H in ((2, 8, 512), LSTM_SHAPES[0]):
        pair = [_lstm_inputs(torch, gen, T, B, H, dev) for _ in range(2)]
        with torch.inference_mode(), exact_fp32():
            got = [lstm_recurrence(*a) for a in pair]
            want = [lstm_recurrence_reference(*a) for a in pair]
            torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            err = _lstm_err(g, w)
            log(f"lstm_recurrence back-to-back T={T} B={B} H={H} launch "
                f"{i + 1}: max_abs_err={err:.3e}")
            if not err <= 1e-5:
                fail(f"lstm_recurrence back-to-back launch {i + 1} "
                     f"disagrees with its plain version: {err}")
            worst = max(worst, err)

    hand = handoff_us()
    T = LSTM_SHAPES[0][0]
    log(f"lstm_recurrence hand-off: {hand:.4f} us one way between two SMs; "
        f"latency floor T x hand-off = {T * hand / 1e3:.4f} ms at T={T}")
    row.update(max_abs_err=worst, per_shape=per_shape, handoff_us=hand,
               latency_floor_ms=T * hand / 1e3)
    return row


def _lstm_bound(T, B, H, peaks):
    """Least time for one layer's recurrence: its products over the fp32
    peak, or its bytes (gx, w_hh, ys, h0, c0, h_T, c_T once) over HBM."""
    flops = 2.0 * T * B * H * 4 * H
    nbytes = 4.0 * (T * B * 4 * H + H * 4 * H + T * B * H + 4 * B * H)
    return bound(flops, nbytes, peaks)


def _lstm_library(torch, gen) -> dict:
    """``nn.LSTM`` (cuDNN, TF32 off) beside the port at the slices' shapes:
    one bidirectional layer of SpeechTokenizer's encoder (T=500, B=8,
    H=1024) against the port's (two input projections, two flips, two
    kernel launches); one 80 ms chunk of EnCodec streaming (T=6, B=8,
    H=512) and EnCodec-48k's layer (T=150, H=512, B=88 and the 32 and 24
    rows of its launches) against the kernel call, its plain version and
    the port's layer."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.lstm import _layer, bilstm, init_lstm_params
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence, lstm_recurrence_reference)

    def cuda_params(cin, H):
        p = init_lstm_params(gen, 1, cin, H)[0]
        p["b"] = (torch.rand(4 * H, generator=gen) * 2 - 1) / math.sqrt(H)
        return {k: v.to("cuda") for k, v in p.items()}

    def load(ref, p, suffix):
        for name, t in (("weight_ih", p["w_ih"].T), ("weight_hh", p["w_hh"].T),
                        ("bias_ih", p["b"])):
            getattr(ref, f"{name}_l0{suffix}").copy_(t)
        getattr(ref, f"bias_hh_l0{suffix}").zero_()

    out = {}
    T, B, H = 500, 8, 1024
    layer = {"fwd": cuda_params(H, H), "bwd": cuda_params(H, H)}
    # as SEANet hands it over: a [B, C, T] tensor seen as [B, T, C]
    x = (torch.randn(B, H, T, generator=gen) * 0.5).to("cuda").transpose(1, 2)
    xc = x.contiguous()
    ref = torch.nn.LSTM(H, H, 1, batch_first=True, bidirectional=True).to(
        "cuda")
    with torch.inference_mode(), exact_fp32():
        load(ref, layer["fwd"], "")
        load(ref, layer["bwd"], "_reverse")
        port_ms = cuda_ms(torch, lambda: bilstm(x, [layer]), reps=5)
        # a contiguous [B, T, C] input takes another GEMM path
        port_contig_ms = cuda_ms(torch, lambda: bilstm(xc, [layer]), reps=5)
        lib_ms = cuda_ms(torch, lambda: ref(x), reps=5)
        err = float((ref(x)[0] - bilstm(x, [layer])).abs().max())
    log(f"bilstm layer T={T} B={B} H={H}: port_ms={port_ms:.4f} "
        f"(contiguous [B, T, C] input {port_contig_ms:.4f}) "
        f"library_ms(nn.LSTM bidirectional)={lib_ms:.4f} "
        f"library_vs_port_max_abs={err:.3e}")
    with torch.inference_mode():
        phase_profile(torch, lambda: bilstm(x, [layer]), port_ms,
                      "bilstm layer", top=6)
        phase_profile(torch, lambda: bilstm(xc, [layer]), port_contig_ms,
                      "bilstm layer, contiguous input", top=3)
    out["bilstm_layer"] = {"T": T, "B": B, "H": H, "port_ms": port_ms,
                           "port_contiguous_input_ms": port_contig_ms,
                           "library_ms": lib_ms, "library_vs_port": err}

    T, B, H = 6, 8, 512
    p = cuda_params(H, H)
    x = (torch.randn(B, T, H, generator=gen) * 0.5).to("cuda")
    h0 = c0 = torch.zeros(B, H, device="cuda")
    ref = torch.nn.LSTM(H, H, 1, batch_first=True).to("cuda")
    with torch.inference_mode(), exact_fp32():
        load(ref, p, "")
        gx = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b"]).contiguous()
        call_ms = cuda_ms(
            torch, lambda: lstm_recurrence(gx, p["w_hh"], h0, c0))
        layer_ms = cuda_ms(torch, lambda: _layer(x, p))
        lib_ms = cuda_ms(torch, lambda: ref(x))
        err = float((ref(x)[0] - _layer(x, p)[0]).abs().max())
    log(f"lstm stream chunk T={T} B={B} H={H}: kernel_call_ms={call_ms:.4f} "
        f"port_layer_ms={layer_ms:.4f} library_ms(nn.LSTM)={lib_ms:.4f} "
        f"library_vs_port_max_abs={err:.3e}")
    out["stream_chunk"] = {"T": T, "B": B, "H": H, "kernel_call_ms": call_ms,
                           "port_layer_ms": layer_ms, "library_ms": lib_ms,
                           "library_vs_port": err}

    # EnCodec-48k's LSTM layer over 88 windows of 150 frames, and its two
    # launch shapes (the wrapper runs 88 rows as 32 + 32 + 24)
    T, H = 150, 512
    p = cuda_params(H, H)
    ref = torch.nn.LSTM(H, H, 1, batch_first=True).to("cuda")
    out["chunked_48k"] = []
    with torch.inference_mode(), exact_fp32():
        load(ref, p, "")
        for B in (32, 24, 88):
            x = (torch.randn(B, T, H, generator=gen) * 0.5).to("cuda")
            h0 = c0 = torch.zeros(B, H, device="cuda")
            gx = (torch.matmul(x.transpose(0, 1), p["w_ih"])
                  + p["b"]).contiguous()
            call_ms = cuda_ms(
                torch, lambda: lstm_recurrence(gx, p["w_hh"], h0, c0))
            plain_ms = cuda_ms(torch, lambda: lstm_recurrence_reference(
                gx, p["w_hh"], h0, c0), reps=3)
            layer_ms = cuda_ms(torch, lambda: _layer(x, p))
            lib_ms = cuda_ms(torch, lambda: ref(x))
            err = float((ref(x)[0] - _layer(x, p)[0]).abs().max())
            log(f"lstm 48k layer T={T} B={B} H={H}: kernel_call_ms="
                f"{call_ms:.4f} plain_ms={plain_ms:.4f} port_layer_ms="
                f"{layer_ms:.4f} library_ms(nn.LSTM)={lib_ms:.4f} "
                f"library_vs_port_max_abs={err:.3e}")
            out["chunked_48k"].append(
                {"T": T, "B": B, "H": H, "kernel_call_ms": call_ms,
                 "plain_ms": plain_ms, "port_layer_ms": layer_ms,
                 "library_ms": lib_ms, "library_vs_port": err})
    return out


def _lstm_main_row(torch, gen, peaks, args, ms, ms1):
    """The kernel line's entry at the main shape: plain version, the port's
    layer, nn.LSTM and the bound."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.lstm import _layer
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence_reference)

    gx, w_hh, h0, c0 = args
    T, B, H4 = gx.shape
    H = H4 // 4
    s = 1.0 / math.sqrt(H)
    w_ih = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * s).to("cuda")
    b = ((torch.rand(4 * H, generator=gen) * 2 - 1) * s).to("cuda")
    with torch.inference_mode(), exact_fp32():
        plain_ms = cuda_ms(
            torch, lambda: lstm_recurrence_reference(gx, w_hh, h0, c0))
        x = (torch.randn(T, B, H, generator=gen) * 0.5).to("cuda")
        p = {"w_ih": w_ih, "w_hh": w_hh, "b": b}
        layer_ms = cuda_ms(torch, lambda: _layer(x.transpose(0, 1), p, h0, c0))
        ref = torch.nn.LSTM(H, H, 1).to("cuda")
        ref.weight_ih_l0.copy_(w_ih.T)
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
        lib_ms = cuda_ms(torch, lambda: ref(x, (h0[None], c0[None])))
        lib_err = float((ref(x, (h0[None], c0[None]))[0]
                         - _layer(x.transpose(0, 1), p, h0, c0)[0]
                         .transpose(0, 1)).abs().max())
    b_ms, b_by = _lstm_bound(T, B, H, peaks)
    log(f"lstm_recurrence T={T} B={B} H={H}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} port_layer_ms={layer_ms:.4f} "
        f"library_ms(nn.LSTM)={lib_ms:.4f} library_vs_port_max_abs="
        f"{lib_err:.3e} bound_ms={b_ms:.4f} ({b_by})")
    return {"name": "lstm_recurrence", "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "audiocodecs_tpu/ops/lstm_pallas.py:195",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "port_layer_ms": layer_ms, "b1_ms": ms1,
            "shape": {"T": T, "B": B, "H": H}}


def _resblock_inputs(torch, gen, B, C, T, dev):
    Hc = C // 2

    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) / math.sqrt(fan_in)).to(dev)

    x = (torch.randn(B, C, T, generator=gen) * 0.5).to(dev)
    weights = (w(Hc, C, 3, fan_in=3 * C), w(Hc, fan_in=3 * C),
               w(C, Hc, 1, fan_in=Hc), w(C, fan_in=Hc),
               w(C, C, 1, fan_in=C), w(C, fan_in=C))
    return x, weights


def phase_resblock(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32, pad1d
    from audiocodecs_tpu_torch.nn.seanet import (
        ResBlock, SEANetConfig, _resnet_plain)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights, seanet_resblock, seanet_resblock_info,
        seanet_resblock_reference)

    gen = torch.Generator().manual_seed(2)
    dev = "cuda"
    cfg = SEANetConfig()
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "cudnn_path_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    per_shape = []
    for B, C, T in RESBLOCK_SHAPES + RESBLOCK_EXTRA:
        x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T,
                                                       dev)
        with torch.inference_mode(), exact_fp32():
            halo = pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2].contiguous()
            args = (x, halo, w1, b1, w2, b2, ws, bs)
            packed = pack_resblock_weights(w1, w2, ws)
            got = seanet_resblock(*args, packed=packed)
            want = seanet_resblock_reference(*args)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        del got, want
        log(f"seanet_resblock B={B} C={C} T={T}: max_abs_err={err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"seanet_resblock disagrees with its plain version: {err}")
        worst = max(worst, err)
        if (B, C, T) in RESBLOCK_EXTRA:
            continue
        blk = ResBlock(C, cfg).to(dev)
        with torch.inference_mode(), exact_fp32():
            for conv, (wt, bt) in zip((*blk.block, blk.shortcut),
                                      ((w1, b1), (w2, b2), (ws, bs))):
                conv.w.copy_(wt)
                conv.b.copy_(bt)
            ms = cuda_ms(torch, lambda: seanet_resblock(*args, packed=packed))
            plain_ms = cuda_ms(torch, lambda: seanet_resblock_reference(*args))
            cudnn_ms = cuda_ms(
                torch, lambda: _resnet_plain(x, blk, cfg, (1, 1)))
            pack_ms = cuda_ms(torch, lambda: pack_resblock_weights(w1, w2, ws))
        info = seanet_resblock_info(C, C // 2)
        Hc = C // 2
        flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
        nbytes = 4.0 * (2 * B * C * T + 2 * B * C
                        + 3 * C * Hc + Hc * C + C * C + Hc + 2 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        share = flops / peaks[0] / (ms / 1e3)
        log(f"seanet_resblock B={B} C={C} T={T}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} cudnn_path_ms={cudnn_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) fp32_share_of_peak={share:.3f} "
            f"pack_ms={pack_ms:.4f} {json.dumps(info)}")
        per_shape.append({"C": C, "T": T, "ms": ms, "plain_ms": plain_ms,
                          "cudnn_path_ms": cudnn_ms, "bound_ms": b_ms,
                          "fp32_share_of_peak": share, "pack_ms": pack_ms,
                          **info})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["cudnn_path_ms"] += cudnn_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    return {"name": "seanet_resblock", "status": "ported",
            "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_pallas.py:96",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "cudnn_path_ms": tot["cudnn_path_ms"],
            "per_shape": per_shape,
            "shape": "sum over the four main-path (C, T) shapes at B=8, "
                     "weights packed once"}


def phase_packed(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.seanet import (
        ResBlock, SEANetConfig, _resnet_plain)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        seanet_resblock_packed, seanet_resblock_packed_reference)

    gen = torch.Generator().manual_seed(3)
    dev = "cuda"
    cfg = SEANetConfig(pad_mode="constant")
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "cudnn_path_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    for B, C, T in PACKED_SHAPES + [PACKED_RAGGED]:
        x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T,
                                                       dev)
        # the packed kernel's layouts: x [B, T, C], w1 [3, C, H], w2 [H, C]
        xt = x.transpose(1, 2).contiguous()
        args = (xt, w1.permute(2, 1, 0).contiguous(), b1,
                w2[..., 0].T.contiguous(), b2, ws[..., 0].T.contiguous(), bs)
        with torch.inference_mode(), exact_fp32():
            got = seanet_resblock_packed(*args)
            want = seanet_resblock_packed_reference(*args)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        log(f"seanet_resblock_packed B={B} C={C} T={T}: max_abs_err={err:.3e}"
            f" (limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"seanet_resblock_packed disagrees with its plain version: "
                 f"{err}")
        worst = max(worst, err)
        if (B, C, T) == PACKED_RAGGED:
            continue
        blk = ResBlock(C, cfg).to(dev)
        with torch.inference_mode(), exact_fp32():
            for conv, (wt, bt) in zip((*blk.block, blk.shortcut),
                                      ((w1, b1), (w2, b2), (ws, bs))):
                conv.w.copy_(wt)
                conv.b.copy_(bt)
            ms = cuda_ms(torch, lambda: seanet_resblock_packed(*args))
            plain_ms = cuda_ms(
                torch, lambda: seanet_resblock_packed_reference(*args))
            cudnn_ms = cuda_ms(torch, lambda: _resnet_plain(
                xt.transpose(1, 2), blk, cfg, (1, 1)).transpose(1, 2))
        Hc = C // 2
        flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
        nbytes = 4.0 * (2 * B * C * T + 3 * C * Hc + Hc * C + C * C + Hc
                        + 2 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        log(f"seanet_resblock_packed B={B} C={C} T={T}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} cudnn_path_ms={cudnn_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"fp32_share_of_peak={flops / peaks[0] / (ms / 1e3):.3f}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["cudnn_path_ms"] += cudnn_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    return {"name": "seanet_resblock_packed", "status": "ported",
            "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_packed.py:123",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "cudnn_path_ms": tot["cudnn_path_ms"],
            "shape": "sum over (C, T) = (32, 240000), (64, 120000) at B=8; "
                     "no model calls it"}


def _unit_inputs(torch, gen, B, C, T, dev):
    def n(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = n(B, C, T, scale=0.5)
    weights = (n(C, C, 7, scale=1 / math.sqrt(7 * C)), n(C, scale=0.1),
               (torch.randn(C, generator=gen).abs() + 0.5).to(dev),
               n(C, C, 1, scale=1 / math.sqrt(C)), n(C, scale=0.1),
               (torch.randn(C, generator=gen).abs() + 0.5).to(dev))
    return x, weights


def phase_dac_resunit(torch, peaks):
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_info, dac_resunit_reference,
        pack_resunit_weights)

    gen = torch.Generator().manual_seed(4)
    dev = "cuda"
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    per_shape = []
    for B, C, T, d in DAC_UNIT_SHAPES + DAC_UNIT_EXTRA:
        x, weights = _unit_inputs(torch, gen, B, C, T, dev)
        with torch.inference_mode():
            packed = pack_resunit_weights(weights[0], weights[3])
            got = dac_resunit(x, *weights, d, packed=packed)
            want = dac_resunit_reference(x, *weights, d)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        del got, want
        log(f"dac_resunit B={B} C={C} T={T} d={d}: max_abs_err={err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"dac_resunit disagrees with its plain version: {err}")
        worst = max(worst, err)
        if (B, C, T, d) in DAC_UNIT_EXTRA:
            continue
        with torch.inference_mode():
            ms = cuda_ms(torch,
                         lambda: dac_resunit(x, *weights, d, packed=packed))
            plain_ms = cuda_ms(
                torch, lambda: dac_resunit_reference(x, *weights, d))
            pack_ms = cuda_ms(
                torch, lambda: pack_resunit_weights(weights[0], weights[3]))
        occ = dac_resunit_info(C, d)
        flops = 2.0 * B * T * 8 * C * C
        nbytes = 4.0 * (2 * B * C * T + 8 * C * C + 4 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        share = flops / peaks[0] / (ms / 1e3)
        log(f"dac_resunit B={B} C={C} T={T} d={d}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} kernel/plain={ms / plain_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by}) fp32_share_of_peak={share:.3f} "
            f"pack_ms={pack_ms:.4f} regs={occ['regs']} "
            f"smem_bytes={occ['smem_bytes']} "
            f"blocks_per_sm={occ['blocks_per_sm']}")
        per_shape.append({"C": C, "T": T, "d": d, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "fp32_share_of_peak": share, "pack_ms": pack_ms,
                          **occ})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    budget = {f"C={C} d={d}": tuple(dac_resunit_info(C, d).values())
              for C in (96, 192, 256) for d in (1, 3, 9)}
    log(f"dac_resunit (regs, smem_bytes, blocks_per_sm): {budget}")
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    return {"name": "dac_resunit", "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/dac_resunit.cu",
            "replaces": "audiocodecs_tpu/ops/dac_resunit_pallas.py:114",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "per_shape": per_shape,
            "shape": "sum over the six fused units of one B=1 x 10 s decode,"
                     " weights packed once"}


def _counters():
    from audiocodecs_tpu_torch.ops.dac_resunit import dac_resunit
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        seanet_resblock, seanet_resblock_packed)

    return {f.__name__: f for f in (lstm_recurrence, seanet_resblock,
                                    seanet_resblock_packed, dac_resunit)}


def reset_counts() -> None:
    for f in _counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in _counters().items()}


def _server_pair(torch, cls, *args, **kwargs):
    """The codec on the card with seeded random weights, and the same
    weights on the CPU."""
    codec = cls(*args, device="cuda",
                generator=torch.Generator().manual_seed(0), **kwargs)
    state = {k: v.detach().cpu() for k, v in codec.state_dict().items()}
    return codec, cls(*args, device="cpu", state_dict=state, **kwargs)


def _noise(rng, shapes):
    return [rng.standard_normal(shape).astype(np.float32) * 0.1
            for shape in shapes]


def _launch_table(lstm, resblock):
    return {"lstm_recurrence": lstm, "seanet_resblock": resblock,
            "seanet_resblock_packed": 0, "dac_resunit": 0}


def phase_main_path(torch, rows):
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights)
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, B, seconds = 24000, 8, 10.0
    T = int(sr * seconds)
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=8)
    requests = _noise(np.random.default_rng(0), [(B, T), (B, T), (1, 79201)])

    # the counted run: the EnCodec path only
    reset_counts()
    answers, packs = [], []
    for sig in requests:
        p0 = pack_resblock_weights.packs
        toks = codec.sig_to_toks(sig)
        answers.append((toks, codec.toks_to_sig(toks)))
        packs.append(pack_resblock_weights.packs - p0)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"EnCodec path launches over {len(requests)} roundtrips: "
        f"{json.dumps(counts)}; seanet_resblock weight packs per roundtrip: "
        f"{packs}")
    n = len(requests)
    want = _launch_table(4 * n, 8 * n)
    if counts != want:
        fail(f"expected launches {want}, got {counts}")
    if packs != [8] + [0] * (n - 1):
        fail(f"expected the fused blocks to pack once, got {packs}")
    _add_launches(rows, "encodec_24k", counts)

    for sig, (toks, y) in zip(requests, answers):
        N = math.ceil(sig.shape[1] / 320)
        if tuple(toks.shape) != (sig.shape[0], N, 8) or tuple(y.shape) != (
                sig.shape[0], N * 320):
            fail(f"shapes: toks {tuple(toks.shape)}, sig {tuple(y.shape)} "
                 f"for input {sig.shape}")
        if not bool(torch.isfinite(y).all()):
            fail("non-finite waveform")
    if tuple(answers[0][0].shape) != (8, 750, 8):
        fail(f"main request tokens {tuple(answers[0][0].shape)}")

    # parity against the plain versions on the CPU, same weights
    for i in (0, 2):
        sig, (toks, y) = requests[i], answers[i]
        f_gpu = codec.sig_to_feats(sig).cpu()
        f_cpu = cpu.sig_to_feats(sig)
        f_err = float((f_gpu - f_cpu).abs().max())
        f_lim = 1e-4 * float(f_cpu.abs().max())
        t_cpu = cpu.sig_to_toks(sig)
        mism = int((toks.cpu() != t_cpu).sum())
        match = 1.0 - mism / t_cpu.numel()
        y_cpu = cpu.toks_to_sig(toks.cpu())
        y_err = float((y.cpu() - y_cpu).abs().max())
        y_lim = 1e-4 * float(y_cpu.abs().max())
        log(f"request {i} {sig.shape}: feats max_abs_diff={f_err:.3e} "
            f"(limit {f_lim:.3e}); token_match={match:.6f} "
            f"({mism} of {t_cpu.numel()} differ); decode max_abs_diff="
            f"{y_err:.3e} (limit {y_lim:.3e})")
        if not f_err <= f_lim:
            fail("features disagree with the CPU path")
        if not match >= 0.999:
            fail(f"token_match {match} < 0.999")
        if not y_err <= y_lim:
            fail("decoded waveform disagrees with the CPU path")

    # warm roundtrip time, stages, peak memory
    sig = requests[0]
    sig_dev = torch.as_tensor(sig, device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    with torch.inference_mode():
        feats = codec._sig_to_feats(sig_dev, None)
        toks = rvq_encode(feats, codec.codebooks, 8)
        q = rvq_decode(toks, codec.codebooks)
        stages = {
            "encoder_ms": cuda_ms(
                torch, lambda: codec._sig_to_feats(sig_dev, None), reps=5),
            "rvq_encode_ms": cuda_ms(
                torch, lambda: rvq_encode(feats, codec.codebooks, 8), reps=5),
            "rvq_decode_ms": cuda_ms(
                torch, lambda: rvq_decode(toks, codec.codebooks), reps=5),
            "decoder_ms": cuda_ms(
                torch, lambda: codec._feats_to_sig(q, None), reps=5),
        }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_stream = seconds / (rt_ms / 1e3)
    log(f"roundtrip B={B} x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={per_stream:.3f} rtf_aggregate={per_stream * B:.3f};"
        f" peak_mem_bytes={peak}")
    log(f"stages: {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)


def phase_dac_path(torch, rows):
    from audiocodecs_tpu_torch.models.dac import (
        DAC, dac_rvq_decode, dac_rvq_encode)
    from audiocodecs_tpu_torch.ops.dac_resunit import pack_resunit_weights

    sr, K, seconds = 44100, 9, 10.0
    codec, cpu = _server_pair(torch, DAC, sr, sr, num_codebooks=K)
    T = int(sr * seconds)
    requests = _noise(np.random.default_rng(1), [(1, T), (1, T), (2, 100001)])
    want_shapes = [((1, 861, K), (1, 440832)), ((1, 861, K), (1, 440832)),
                   ((2, 195, K), (2, 99840))]

    # the counted run: the DAC path only
    reset_counts()
    answers, per_call, packs = [], [], []
    for sig in requests:
        before = read_counts()["dac_resunit"]
        toks = codec.sig_to_toks(sig)
        mid = read_counts()["dac_resunit"]
        p0 = pack_resunit_weights.packs
        y = codec.toks_to_sig(toks)
        per_call.append((mid - before, read_counts()["dac_resunit"] - mid))
        packs.append(pack_resunit_weights.packs - p0)
        answers.append((toks, y))
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"DAC path launches over {len(requests)} roundtrips: "
        f"{json.dumps(counts)}; dac_resunit (sig_to_toks, toks_to_sig) per "
        f"request: {per_call}; weight packs per toks_to_sig: {packs}")
    n = len(requests)
    want = {"lstm_recurrence": 0, "seanet_resblock": 0,
            "seanet_resblock_packed": 0, "dac_resunit": 6 * n}
    if counts != want or any(c != (0, 6) for c in per_call):
        fail(f"expected launches {want} and (0, 6) per request, got "
             f"{counts}, {per_call}")
    if packs != [6] + [0] * (n - 1):
        fail(f"expected the fused units to pack once, got {packs}")
    _add_launches(rows, "dac_44k", counts)

    for sig, (toks, y), (ts, ys) in zip(requests, answers, want_shapes):
        if tuple(toks.shape) != ts or tuple(y.shape) != ys:
            fail(f"shapes: toks {tuple(toks.shape)}, sig {tuple(y.shape)} "
                 f"for input {sig.shape}; want {ts}, {ys}")
        if not bool(torch.isfinite(y).all()):
            fail("non-finite waveform")

    # parity against the plain versions on the CPU, same weights: the
    # ragged request, then one 10 s request (3 s if the CPU would take over
    # 120 s for it)
    def parity(label, sig, toks, y):
        t0 = time.perf_counter()
        f_gpu = codec.sig_to_feats(sig).cpu()
        f_cpu = cpu.sig_to_feats(sig)
        with torch.inference_mode():
            t_cpu = dac_rvq_encode(f_cpu, cpu.quantizer, K)
        y_cpu = cpu.toks_to_sig(toks.cpu())
        cpu_s = time.perf_counter() - t0
        f_err = float((f_gpu - f_cpu).abs().max())
        f_lim = 1e-4 * float(f_cpu.abs().max())
        mism = int((toks.cpu() != t_cpu).sum())
        match = 1.0 - mism / t_cpu.numel()
        y_err = float((y.cpu() - y_cpu).abs().max())
        y_lim = 1e-4 * float(y_cpu.abs().max())
        log(f"DAC {label} {sig.shape}: feats max_abs_diff={f_err:.3e} "
            f"(limit {f_lim:.3e}); token_match={match:.6f} ({mism} of "
            f"{t_cpu.numel()} differ); decode max_abs_diff={y_err:.3e} "
            f"(limit {y_lim:.3e}); cpu_seconds={cpu_s:.1f}")
        if not f_err <= f_lim:
            fail("DAC features disagree with the CPU path")
        if not match >= 0.999:
            fail(f"DAC token_match {match} < 0.999")
        if not y_err <= y_lim:
            fail("DAC decoded waveform disagrees with the CPU path")
        return cpu_s

    cpu_s = parity("request 2", requests[2], *answers[2])
    est = cpu_s * T / requests[2].size
    if est <= 120.0:
        parity("request 0", requests[0], *answers[0])
    else:
        short = np.ascontiguousarray(requests[0][:, : 3 * sr])
        log(f"DAC 10 s parity would take ~{est:.0f} s on the CPU: checking "
            f"the first 3 s of request 0 instead")
        toks = codec.sig_to_toks(short)
        parity("request 0, first 3 s", short, toks, codec.toks_to_sig(toks))

    # warm roundtrip time, stages, peak memory
    sig_dev = torch.as_tensor(requests[0], device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    with torch.inference_mode():
        feats = codec._encode_feats(sig_dev, None)
        toks = dac_rvq_encode(feats, codec.quantizer, K)
        q = dac_rvq_decode(toks, codec.quantizer)
        stages = {
            "encoder_ms": cuda_ms(
                torch, lambda: codec._encode_feats(sig_dev, None), reps=5),
            "rvq_encode_ms": cuda_ms(
                torch, lambda: dac_rvq_encode(feats, codec.quantizer, K),
                reps=5),
            "rvq_decode_ms": cuda_ms(
                torch, lambda: dac_rvq_decode(toks, codec.quantizer), reps=5),
            "decoder_ms": cuda_ms(
                torch, lambda: codec._feats_to_sig(q, None), reps=5),
        }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"DAC roundtrip B=1 x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={seconds / (rt_ms / 1e3):.3f}; "
        f"peak_mem_bytes={peak}")
    log(f"DAC stages: "
        f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)


def _add_launches(rows, path: str, counts: dict) -> None:
    for row in rows:
        row.setdefault("launches_by_path", {})[path] = counts[row["name"]]
        row["launches"] += counts[row["name"]]


def _parity(label, codec, cpu, sig, toks, y, n_rows=None):
    """The card's features, tokens and decode of ``sig`` (its first
    ``n_rows`` rows) against the CPU path on the same weights: features
    within 1e-4 · max|feats|, token_match ≥ 0.999, the decode of the same
    tokens within 1e-4 · max|sig|."""
    rows = slice(0, n_rows)
    t0 = time.perf_counter()
    f_gpu = codec.sig_to_feats(sig)[rows].cpu()
    sig = np.ascontiguousarray(sig[rows])
    f_cpu = cpu.sig_to_feats(sig)
    t_cpu = cpu.sig_to_toks(sig)
    toks, y = toks[rows].cpu(), y[rows].cpu()
    y_cpu = cpu.toks_to_sig(toks)
    cpu_s = time.perf_counter() - t0
    f_err = float((f_gpu - f_cpu).abs().max())
    f_lim = 1e-4 * float(f_cpu.abs().max())
    mism = int((toks != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    y_err = float((y - y_cpu).abs().max())
    y_lim = 1e-4 * float(y_cpu.abs().max())
    log(f"{label} {sig.shape}: feats max_abs_diff={f_err:.3e} (limit "
        f"{f_lim:.3e}); token_match={match:.6f} ({mism} of {t_cpu.numel()} "
        f"differ); decode max_abs_diff={y_err:.3e} (limit {y_lim:.3e}); "
        f"cpu_seconds={cpu_s:.1f}")
    if not f_err <= f_lim:
        fail(f"{label}: features disagree with the CPU path")
    if not match >= 0.999:
        fail(f"{label}: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{label}: decoded waveform disagrees with the CPU path")


def _batch_path(torch, rows, path, codec, cpu, requests, per_roundtrip,
                shapes, quant, parity_rows=2, profile_decode=None):
    """A codec as a small server: the requests through ``sig_to_toks`` →
    ``toks_to_sig`` with every kernel's launches counted (``per_roundtrip``
    each, or ``per_roundtrip(sig_shape)`` where it depends on the request),
    the shapes (``shapes(sig_shape)`` → (toks, sig)) and finite output
    checked, parity against the CPU path on the last request and on the
    first ``parity_rows`` rows of the first (none if ``None``), then the warm
    roundtrip of the first request timed: ms, RTF per stream and in
    aggregate, peak memory, stages (``quant`` = (tokens of features,
    features of tokens, waveform of features), or ``None``) and the device
    time by kernel, also of the decode from features alone when
    ``profile_decode`` names it."""
    reset_counts()
    answers = []
    for sig in requests:
        toks = codec.sig_to_toks(sig)
        answers.append((toks, codec.toks_to_sig(toks)))
    torch.cuda.synchronize()
    counts = read_counts()
    n = len(requests)
    log(f"{path} launches over {n} roundtrips: {json.dumps(counts)}")
    each = [per_roundtrip(sig.shape) if callable(per_roundtrip)
            else per_roundtrip for sig in requests]
    want = {k: sum(e[k] for e in each) for k in each[0]}
    if counts != want:
        fail(f"{path}: expected launches {want}, got {counts}")
    _add_launches(rows, path, counts)
    for sig, (toks, y) in zip(requests, answers):
        ts, ys = shapes(sig.shape)
        if tuple(toks.shape) != ts or tuple(y.shape) != ys:
            fail(f"{path} shapes: toks {tuple(toks.shape)}, sig "
                 f"{tuple(y.shape)} for input {sig.shape}; want {ts}, {ys}")
        if not bool(torch.isfinite(y).all()):
            fail(f"{path}: non-finite waveform")
    _parity(f"{path} request {n - 1}", codec, cpu, requests[-1],
            *answers[-1])
    if parity_rows is not None:
        _parity(f"{path} request 0, rows 0-{parity_rows - 1}", codec, cpu,
                requests[0], *answers[0], n_rows=parity_rows)

    sig = requests[0]
    B, seconds = sig.shape[0], sig.shape[1] / codec.sample_rate
    sig_dev = torch.as_tensor(sig, device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    if quant is not None:
        to_toks, to_q, to_sig = quant
        with torch.inference_mode():
            feats = codec._sig_to_feats(sig_dev, None)
            toks = to_toks(feats)
            q = to_q(toks)
            stages = {
                "encoder_ms": cuda_ms(
                    torch, lambda: codec._sig_to_feats(sig_dev, None),
                    reps=5),
                "rvq_encode_ms": cuda_ms(torch, lambda: to_toks(feats),
                                         reps=5),
                "rvq_decode_ms": cuda_ms(torch, lambda: to_q(toks), reps=5),
                "decoder_ms": cuda_ms(torch, lambda: to_sig(q), reps=5),
            }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_stream = seconds / (rt_ms / 1e3)
    log(f"{path} roundtrip B={B} x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={per_stream:.3f} rtf_aggregate={per_stream * B:.3f};"
        f" peak_mem_bytes={peak}")
    if quant is not None:
        log(f"{path} stages: "
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)
    if profile_decode is not None:
        with torch.inference_mode():
            phase_profile(torch, lambda: to_sig(q), stages["decoder_ms"],
                          profile_decode)


def phase_speechtokenizer(torch, rows):
    from audiocodecs_tpu_torch.models.speechtokenizer import SpeechTokenizer
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 16000, 8, 320
    codec, cpu = _server_pair(torch, SpeechTokenizer, sr, sr, num_codebooks=K)
    requests = _noise(np.random.default_rng(5),
                      [(8, 10 * sr), (8, 10 * sr), (1, 80001)])

    def shapes(shape):
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)

    # 2 encoder BiLSTM layers x 2 directions + 2 decoder LSTM layers
    _batch_path(torch, rows, "speechtokenizer_16k", codec, cpu, requests,
                _launch_table(6, 0), shapes,
                (lambda f: rvq_encode(f, codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: codec._feats_to_sig(q, None)))


def _stream(torch, codec, sig, frames: int, toks_in=None):
    """``sig`` [B, T] through ``encode_chunk`` then ``decode_chunk`` in
    chunks of ``frames`` token frames (the decoder takes ``toks_in``'s
    chunk if given, else the encoder's), synced after each chunk on the
    card → (tokens, waveform, ms a chunk by the host's clock)."""
    step = codec.frame_size * frames
    enc = codec.init_streaming_state(sig.shape[0])
    dec = codec.init_streaming_state(sig.shape[0])
    on_card = codec.device.type == "cuda"
    toks, wav, ms = [], [], []
    for i, pos in enumerate(range(0, sig.shape[1], step)):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t, enc = codec.encode_chunk(sig[:, pos:pos + step], enc)
        w, dec = codec.decode_chunk(
            t if toks_in is None else toks_in[:, i * frames:(i + 1) * frames],
            dec)
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(t)
        wav.append(w)
    return torch.cat(toks, 1), torch.cat(wav, 1), ms


def _stream_times(torch, path, codec, sig_dev, frames, seconds):
    """A second, warm pass of the stream: median and p90 ms a chunk
    (encode + decode, synced each chunk) and the RTF a stream; then the
    device time by kernel over the first 10 chunks of a third pass."""
    _, _, ms = _stream(torch, codec, sig_dev, frames)
    srt = sorted(ms)
    p90 = srt[min(len(srt) - 1, math.ceil(0.9 * len(srt)) - 1)]
    chunk_s = codec.frame_size * frames / codec.sample_rate
    log(f"{path} stream B={sig_dev.shape[0]} x {seconds} s in {len(ms)} "
        f"chunks of {chunk_s * 1e3:.0f} ms: chunk_ms median="
        f"{statistics.median(ms):.3f} p90={p90:.3f} max={srt[-1]:.3f}; "
        f"rtf_per_stream={seconds / (sum(ms) / 1e3):.3f}")
    n = codec.frame_size * frames * 10
    phase_profile(torch,
                  lambda: _stream(torch, codec, sig_dev[:, :n], frames),
                  statistics.median(ms) * 10, "10 chunks (10 x median)",
                  top=8)


def _stream_path(torch, rows, path, codec, cpu, sig, frames, seconds):
    """``sig`` [B, T] through ``encode_chunk`` then ``decode_chunk`` in
    chunks of ``frames`` token frames, four kernel-1 launches a chunk (2
    encoder + 2 decoder LSTM layers) and no other, against the CPU path's
    stream on two rows (its decoder fed the card's tokens); then the chunk
    times (``_stream_times``)."""
    sig_dev = torch.as_tensor(sig, device="cuda")
    n_chunks = sig.shape[1] // (codec.frame_size * frames)
    K = codec.config.num_codebooks
    reset_counts()
    toks, wav, _ = _stream(torch, codec, sig_dev, frames)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{path} launches over {n_chunks} chunks: {json.dumps(counts)}")
    want = _launch_table(4 * n_chunks, 0)
    if counts != want:
        fail(f"{path}: expected launches {want}, got {counts}")
    _add_launches(rows, path, counts)
    if tuple(toks.shape) != (sig.shape[0], sig.shape[1] // codec.frame_size,
                             K) or tuple(wav.shape) != sig.shape:
        fail(f"{path} shapes: toks {tuple(toks.shape)}, sig "
             f"{tuple(wav.shape)}")
    if not bool(torch.isfinite(wav).all()):
        fail(f"{path}: non-finite waveform")

    t0 = time.perf_counter()
    t_cpu, y_cpu, _ = _stream(torch, cpu, np.ascontiguousarray(sig[:2]),
                              frames, toks_in=toks[:2].cpu())
    mism = int((toks[:2].cpu() != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    y_err = float((wav[:2].cpu() - y_cpu).abs().max())
    y_lim = 1e-4 * float(y_cpu.abs().max())
    log(f"{path} rows 0-1 against the CPU stream: token_match={match:.6f} "
        f"({mism} of {t_cpu.numel()} differ); decode max_abs_diff="
        f"{y_err:.3e} (limit {y_lim:.3e}); cpu_seconds="
        f"{time.perf_counter() - t0:.1f}")
    if not match >= 0.999:
        fail(f"{path}: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{path}: decoded waveform disagrees with the CPU path")
    _stream_times(torch, path, codec, sig_dev, frames, seconds)


def phase_encodec_stream(torch, rows):
    from audiocodecs_tpu_torch.models.encodec import Encodec

    sr, K, frames, seconds = 24000, 8, 6, 10.0
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K)
    sig, = _noise(np.random.default_rng(6), [(8, int(sr * seconds))])
    _stream_path(torch, rows, "encodec_24k_stream", codec, cpu, sig, frames,
                 seconds)


def phase_mimi(torch, rows):
    from audiocodecs_tpu_torch.models.mimi import Mimi

    sr, K, seconds = 24000, 8, 10.0
    codec, cpu = _server_pair(torch, Mimi, sr, sr, num_codebooks=K)
    T = int(sr * seconds)
    requests = _noise(np.random.default_rng(7), [(8, T), (8, T), (1, 79201)])
    hop, stride = 960, codec.model_config.downsample_stride

    def shapes(shape):
        N = math.ceil(math.ceil(shape[1] / hop) / stride)
        return (shape[0], N, K), (shape[0], N * hop * stride)

    path = "mimi_24k"
    none = _launch_table(0, 0)
    _batch_path(torch, rows, path, codec, cpu, requests, none, shapes,
                (codec._encode, codec._decode, codec._decode_tower))

    # streaming, one 80 ms frame a chunk, against the card's batch path
    sig_dev = torch.as_tensor(requests[0], device="cuda")
    reset_counts()
    toks, wav, _ = _stream(torch, codec, sig_dev, 1)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{path} stream launches: {json.dumps(counts)}")
    if counts != none:
        fail(f"{path} stream: expected no launches, got {counts}")
    batch = codec.sig_to_toks(sig_dev)
    if tuple(toks.shape) != tuple(batch.shape) or tuple(wav.shape) != (
            8, T):
        fail(f"{path} stream shapes: toks {tuple(toks.shape)}, sig "
             f"{tuple(wav.shape)}")
    mism = int((toks != batch).sum())
    match = 1.0 - mism / batch.numel()
    y_batch = codec.toks_to_sig(toks)
    y_err = float((wav - y_batch).abs().max())
    y_lim = 1e-4 * float(y_batch.abs().max())
    log(f"{path} stream against batch on the card: token_match={match:.6f} "
        f"({mism} of {batch.numel()} differ); waveform max_abs_diff="
        f"{y_err:.3e} (limit {y_lim:.3e})")
    if not match >= 0.999:
        fail(f"{path} stream: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{path} stream: waveform disagrees with batch decode")
    _stream_times(torch, path, codec, sig_dev, 1, seconds)


def phase_wavtokenizer(torch, rows):
    """WavTokenizer-24k: the encoder's 2 LSTM layers and 4 causal blocks on
    the kernels, the Vocos head (768 wide, 12 blocks) on library calls."""
    from audiocodecs_tpu_torch.models.wavtokenizer import WavTokenizer
    from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

    sr, hop = 24000, 320
    codec, cpu = _server_pair(torch, WavTokenizer, sr, sr)
    requests = _noise(np.random.default_rng(8),
                      [(8, 10 * sr), (8, 10 * sr), (1, 79201)])

    def shapes(shape):
        # the head's ISTFT trims n_fft/2 a side: (N - 1) hops
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, 1), (shape[0], (N - 1) * hop)

    _batch_path(torch, rows, "wavtokenizer_24k", codec, cpu, requests,
                _launch_table(2, 4), shapes,
                (lambda f: vq_encode(f, codec.codebook)[..., None],
                 lambda t: vq_decode(t[..., 0], codec.codebook),
                 lambda q: codec._feats_to_sig(q, None)),
                profile_decode="decode from features (Vocos head)")


def phase_encodec_vocos(torch, rows):
    """EnCodec-24k's encoder, K = 8 (AdaLN row 2, 6 kbps), and the Vocos
    head (``VocosConfig()``) in place of the SEANet decoder."""
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.nn.vocos import apply_vocos
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 24000, 8, 320
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K,
                              use_vocos=True)
    if codec._bandwidth_id != 2:
        fail(f"encodec_vocos: bandwidth id {codec._bandwidth_id}, want 2")
    requests = _noise(np.random.default_rng(9),
                      [(8, 10 * sr), (8, 10 * sr), (1, 79201)])

    def shapes(shape):
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], (N - 1) * hop)

    _batch_path(torch, rows, "encodec_vocos_24k", codec, cpu, requests,
                _launch_table(2, 4), shapes,
                (lambda f: rvq_encode(f, codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: apply_vocos(codec.vocos, q, codec.vocos_config,
                                       cond_id=codec._bandwidth_id)),
                profile_decode="decode from features (Vocos head)")


def phase_encodec_48k(torch, rows):
    """EnCodec-48k's chunking (1 s windows, 1 % overlap, normalized,
    non-causal), mono and without time group norm as the JAX package has
    it: 10 s is 11 windows a stream, so B = 8 is 88 windows of 150 frames
    through one encoder call, the LSTMs at (150, 88, 512) in 3 launches a
    layer (32 rows a launch at H = 512). The CPU checks a B = 1 x 2.97 s
    request (3 windows): the 88 windows would take minutes there."""
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec, EncodecModelConfig)

    sr, K = 48000, 8
    mc = EncodecModelConfig(sampling_rate=sr, use_causal_conv=False,
                            normalize=True, chunk_length_s=1.0, overlap=0.01,
                            num_quantizers=16)
    L, S = mc.chunk_length, mc.chunk_stride
    frames = L // mc.hop_length
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K,
                              model_config=mc)
    # the CPU's request: 2.97 s, the longest that is 3 windows
    requests = _noise(np.random.default_rng(10),
                      [(8, 10 * sr), (8, 10 * sr), (1, 3 * S)])
    log(f"encodec_48k_chunked: CPU parity on request 2, B = 1 x {3 * S} "
        f"samples (3 windows), not on the timed B = 8 x 10 s (88 windows)")

    def windows(shape):
        return shape[0] * max(1, math.ceil(shape[1] / S))

    def launches(shape):
        # 2 layers a LSTM, encoder and decoder, 32 rows a launch
        return _launch_table(4 * math.ceil(windows(shape) / 32), 0)

    def shapes(shape):
        n = windows(shape) // shape[0]
        return (shape[0], n * frames, K), (shape[0], S * (n - 1) + L)

    _batch_path(torch, rows, "encodec_48k_chunked", codec, cpu, requests,
                launches, shapes, None, parity_rows=None)


def phase_past(torch, rows):
    """PAST-16k (streamable): the causal SEANet's 4 LSTM layers and 8
    blocks on the kernels a roundtrip; then the first request streamed in
    80 ms chunks (4 frames), 4 LSTM launches a chunk."""
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 16000, 8, 320
    codec, cpu = _server_pair(torch, PAST, sr, sr, num_codebooks=K)
    requests = _noise(np.random.default_rng(11),
                      [(8, 10 * sr), (8, 10 * sr), (1, 80001)])

    def shapes(shape):
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)

    _batch_path(torch, rows, "past_16k", codec, cpu, requests,
                _launch_table(4, 8), shapes,
                (lambda f: rvq_encode(codec._project(f), codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: codec._decode(codec._unproject(q))))
    _stream_path(torch, rows, "past_16k_stream", codec, cpu, requests[0], 4,
                 10.0)


def _function_grad(torch, fn, plain, args, g_outs):
    """The Function ``fn`` (kernel forward, backward recomputed through the
    plain version) against autograd through ``plain`` on the same inputs
    on the card: the worst forward error relative to max(1, max|plain
    output|) (the kernel against its plain version at this shape), the
    worst gradient error relative to the plain gradient's max|g| (the
    backward's wiring: both sides differentiate the plain version), and
    the ms of one backward of each (CUDA events; the graphs are kept, so
    the Function's backward recomputes every time)."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    leaves = [a for a in args if a.requires_grad]
    outs, grads, ms = [], [], []
    with exact_fp32():
        for f in (fn, plain):
            out = f(*args)
            out = out if isinstance(out, tuple) else (out,)
            grads.append(torch.autograd.grad(out, leaves, g_outs,
                                             retain_graph=True))
            ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                out, leaves, g_outs, retain_graph=True), reps=5, warmup=1))
            outs.append(tuple(o.detach() for o in out))
            del out
    fwd = max(float((o - w).abs().max()) / max(1.0, float(w.abs().max()))
              for o, w in zip(*outs))
    err = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(*grads))
    return fwd, err, ms[0], ms[1]


def phase_train_grads(torch, rows, card):
    """Each kernel's Function against the plain version on the card, at
    the training path's shapes: the forward (the kernel) within 1e-5 of
    max(1, max|out|), the gradient within 1e-4 of max|g|."""
    from audiocodecs_tpu_torch.nn.layers import pad1d
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_reference, pack_resunit_weights)
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence, lstm_recurrence_reference)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights, seanet_resblock, seanet_resblock_packed,
        seanet_resblock_packed_reference, seanet_resblock_reference)

    gen = torch.Generator().manual_seed(9)
    by_name = {r["name"]: r for r in rows}

    def req(t):
        return t.to("cuda").requires_grad_()

    def g_like(*shape):
        return (torch.randn(*shape, generator=gen)).to("cuda")

    def record(name, label, fwd, err, bwd_ms, plain_bwd_ms):
        log(f"{name} training shape {label}: forward max_rel_err={fwd:.3e} "
            f"(limit 1e-5), gradient max_rel_err={err:.3e} (limit 1e-4) "
            f"backward_ms={bwd_ms:.4f} plain_backward_ms={plain_bwd_ms:.4f} "
            f"({card})")
        if not fwd <= 1e-5:
            fail(f"{name}: the kernel disagrees with its plain version at "
                 f"{label}: {fwd}")
        if not err <= 1e-4:
            fail(f"{name}: the Function's gradient disagrees with the plain "
                 f"version's at {label}: {err}")
        row = by_name[name]
        row["grad_fwd_max_err"] = max(row.get("grad_fwd_max_err", 0.0), fwd)
        row["grad_max_err"] = max(row.get("grad_max_err", 0.0), err)
        row["grad_backward_ms"] = row.get("grad_backward_ms", 0.0) + bwd_ms
        row["plain_backward_ms"] = (row.get("plain_backward_ms", 0.0)
                                    + plain_bwd_ms)
        row.setdefault("grad_shapes", []).append(label)

    T, B, H = TRAIN_GRAD_LSTM
    args = [req(a) for a in _lstm_inputs(torch, gen, T, B, H, "cpu")]
    record("lstm_recurrence", f"T={T} B={B} H={H}", *_function_grad(
        torch, lstm_recurrence, lstm_recurrence_reference, args,
        [g_like(T, B, H), g_like(B, H), g_like(B, H)]))

    for B, C, T in TRAIN_GRAD_BLOCKS:
        x, weights = _resblock_inputs(torch, gen, B, C, T, "cpu")
        x, weights = req(x), [req(w) for w in weights]
        packed = pack_resblock_weights(weights[0], weights[2], weights[4])

        def halo(x):
            return pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2].contiguous()

        record("seanet_resblock", f"B={B} C={C} T={T}", *_function_grad(
            torch, lambda x, *w: seanet_resblock(x, halo(x), *w,
                                                 packed=packed),
            lambda x, *w: seanet_resblock_reference(x, halo(x), *w),
            [x, *weights], [g_like(B, C, T)]))

    B, C, T = TRAIN_GRAD_PACKED
    x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T, "cpu")
    args = [req(a) for a in (x.transpose(1, 2).contiguous(),
                             w1.permute(2, 1, 0).contiguous(), b1,
                             w2[..., 0].T.contiguous(), b2,
                             ws[..., 0].T.contiguous(), bs)]
    record("seanet_resblock_packed", f"B={B} C={C} T={T}", *_function_grad(
        torch, seanet_resblock_packed, seanet_resblock_packed_reference,
        args, [g_like(B, T, C)]))

    B, C, T, d = TRAIN_GRAD_UNIT
    x, weights = _unit_inputs(torch, gen, B, C, T, "cpu")
    x, weights = req(x), [req(w) for w in weights]
    packed = pack_resunit_weights(weights[0], weights[3])
    record("dac_resunit", f"B={B} C={C} T={T} d={d}", *_function_grad(
        torch, lambda x, *w: dac_resunit(x, *w, d, packed=packed),
        lambda x, *w: dac_resunit_reference(x, *w, d), [x, *weights],
        [g_like(B, C, T)]))


def _train_batches(rng, B, seconds, sr, n):
    """``examples/train_codec.py``'s synthetic batches: the example signal
    at a random gain in [0.5, 1) plus N(0, 0.05²) noise."""
    from audiocodecs_tpu_torch.utils.audio import example_signal

    base = example_signal(sr, seconds)
    out = []
    for _ in range(n):
        noise = rng.standard_normal((B, base.shape[0])).astype(np.float32)
        out.append((base[None] * rng.uniform(0.5, 1.0)
                    + 0.05 * noise).astype(np.float32))
    return out


def _trainer(torch, model):
    """EnCodec's published recipe on one card: Adam at 3e-4, betas (0.5,
    0.9); EMA codebooks (decay 0.99); the spectral term at weight 1.0,
    ramped in over two updates from the first."""
    from audiocodecs_tpu_torch.parallel.train import (
        init_codec_opt_state, make_codec_train_step)

    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4,
                                 betas=(0.5, 0.9))
    state = init_codec_opt_state(optimizer, model, 8)
    step = make_codec_train_step(model, 8, spec_weight=1.0, ema_decay=0.99,
                                 spec_delay=0, spec_ramp=2)
    return state, step


def _rel_l2(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _train_parity(torch, sr):
    """Step 1 on the card against the port's CPU path: same weights, same
    B = 2 x 1 s batch. Losses within 1e-4 relative, each gradient within
    1e-3 relative L2, the tokens of the batch (token_match >= 0.999), the
    EMA codebooks after the update within 1e-4 of max|codebook|."""
    from audiocodecs_tpu_torch.models.encodec import Encodec

    model, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=8)
    sig, = _train_batches(np.random.default_rng(1), 2, 1.0, sr, 1)
    toks, t_cpu = model.sig_to_toks(sig).cpu(), cpu.sig_to_toks(sig)
    mism = int((toks != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    t0 = time.perf_counter()
    mets = []
    for m in (model, cpu):
        state, step = _trainer(torch, m)
        mets.append({k: float(v) for k, v in step(state, sig).items()})
    cpu_s = time.perf_counter() - t0
    m_err = {k: abs(mets[0][k] - mets[1][k]) / max(abs(mets[1][k]), 1e-30)
             for k in ("loss", "recon", "commit", "spec")}
    g_err = {}
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        if p.grad is None or q.grad is None:
            if not (p.grad is None and q.grad is None and name == "codebooks"):
                fail(f"train parity: {name} has a gradient on one side only")
            continue
        g_err[name] = _rel_l2(p.grad.cpu(), q.grad)
    worst = max(g_err, key=g_err.get)
    cb_err = float((model.codebooks.detach().cpu() - cpu.codebooks.detach())
                   .abs().max()) / float(cpu.codebooks.detach().abs().max())
    log(f"train step 1, card vs CPU (B=2 x 1 s): token_match={match:.6f} "
        f"({mism} of {t_cpu.numel()} differ); metrics rel err "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in m_err.items()})} "
        f"(limit 1e-4); gradient rel L2 worst {g_err[worst]:.3e} ({worst}; "
        f"limit 1e-3) over {len(g_err)} tensors; EMA codebooks after the "
        f"update max_rel_err={cb_err:.3e} (limit 1e-4); cpu_seconds="
        f"{cpu_s:.1f}")
    if not match >= 0.999:
        fail(f"train parity: token_match {match} < 0.999")
    if not max(m_err.values()) <= 1e-4:
        fail(f"train parity: metrics differ from the CPU path: {m_err}")
    if not g_err[worst] <= 1e-3:
        fail(f"train parity: gradient of {worst} differs from the CPU path "
             f"by {g_err[worst]} (relative L2)")
    if not cb_err <= 1e-4:
        fail(f"train parity: EMA codebooks differ from the CPU path: {cb_err}")


def phase_train(torch, rows, card):
    """EnCodec-24 kHz training at its published width on the card: each
    kernel and its Function at the path's shapes (``phase_train_grads``),
    step 1 against the CPU path (``_train_parity``), then the counted run
    of ``TRAIN_STEPS`` steps on B = 8 x 1 s synthetic batches (4 B1 and 8
    B2 launches a step, every encoder and decoder gradient finite and
    nonzero after step 1), the warm step's time (median of steps 3-8, CUDA
    events), audio seconds a wall second, peak memory, and one profiled
    step: its split into forward, backward and update, the kernels each
    part launched, and the time of B1's and B2's recompute inside the
    backward (``_train_step_split``)."""
    from audiocodecs_tpu_torch.models.encodec import Encodec

    sr = 24000
    phase_train_grads(torch, rows, card)
    _train_parity(torch, sr)

    model = Encodec(sr, sr, num_codebooks=8, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    state, step = _trainer(torch, model)
    batches = [torch.as_tensor(b, device="cuda") for b in _train_batches(
        np.random.default_rng(0), TRAIN_B, 1.0, sr, TRAIN_STEPS + 2)]
    torch.cuda.synchronize()

    # the counted run: the training path only
    reset_counts()
    recon, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        met = step(state, batches[i])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        recon.append(float(met["recon"]))
        if not all(math.isfinite(float(v)) for v in met.values()):
            fail(f"train step {i + 1}: non-finite metrics {met}")
        if i == 0:
            bad = [n for n, p in model.named_parameters() if n != "codebooks"
                   and (p.grad is None or not bool(torch.isfinite(p.grad).all())
                        or float(p.grad.abs().max()) == 0.0)]
            n_params = sum(1 for _ in model.parameters())
            log(f"train step 1 gradient coverage: {n_params - 1 - len(bad)} "
                f"of {n_params - 1} encoder and decoder tensors finite and "
                f"nonzero; codebooks (EMA) gradient "
                f"{'none' if model.codebooks.grad is None else 'present'}")
            if bad or model.codebooks.grad is not None:
                fail(f"train step 1: gradients missing, zero or non-finite: "
                     f"{bad[:8]}")
    counts = read_counts()
    log(f"encodec_24k_train launches over {TRAIN_STEPS} steps: "
        f"{json.dumps(counts)}; a step: {per_step[0]}")
    if counts != _launch_table(4 * TRAIN_STEPS, 8 * TRAIN_STEPS) or any(
            s != _launch_table(4, 8) for s in per_step):
        fail(f"encodec_24k_train: expected 4 B1 and 8 B2 launches a step, "
             f"got {per_step}")
    _add_launches(rows, "encodec_24k_train", counts)
    log(f"train recon over steps 1-{TRAIN_STEPS}: "
        f"{json.dumps([round(r, 6) for r in recon])}")

    warm = statistics.median(step_ms[TRAIN_TIMED])
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[TRAIN_STEPS])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"train warm step B={TRAIN_B} x 1 s ({card}): median "
        f"{warm:.3f} ms over steps 3-{TRAIN_STEPS} "
        f"{json.dumps([round(t, 3) for t in step_ms])}; "
        f"audio_seconds_per_wall_second={TRAIN_B * 1.0 / (warm / 1e3):.3f}; "
        f"peak_mem_bytes={peak}")
    before = read_counts()
    prof = phase_profile(torch, lambda: step(state, batches[TRAIN_STEPS + 1]),
                         warm, what=f"train step ({card})")
    after = read_counts()
    if {k: after[k] - before[k] for k in after} != _launch_table(4, 8):
        fail(f"train step: the profiled step did not launch 4 B1 and 8 B2: "
             f"{before} -> {after}")
    if prof is None:
        fail("train step: the profiler saw no device time, so the step's "
             "split and its launches by part cannot be read")
    _train_step_split(prof, card)


# the device name of each counted wrapper's kernel (B3 runs B2's kernel)
_KERNEL_NAMES = {"lstm_recurrence": "lstm_recurrence_kernel",
                 "seanet_resblock": "seanet_resblock_kernel",
                 "dac_resunit": "dac_resunit_kernel"}
_STEP_PARTS = ("forward", "backward", "update")


def _train_step_split(prof, card):
    """The profiled train step taken apart by ``make_codec_train_step``'s
    own ranges ``codec_train_step.{forward,backward,update}``: each part's
    host time and device window, the package's kernels launched in each
    (4 B1 and 8 B2 in the forward, none in the backward or the update),
    and the recompute ranges of B1's and B2's Functions inside the
    backward.

    The forward and the update launch from the calling thread, so their
    ranges' device spans hold their kernels. The backward's kernels are
    launched by autograd's device thread, outside the caller's range: on
    the one stream they run after the forward's last kernel and before the
    update's first, so that gap is the backward's device window (its idle
    time included)."""
    from torch.autograd import DeviceType

    spans, host, kernels = {}, {}, []
    for evt in prof.events():
        name = evt.name
        if evt.device_type == DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):
                spans.setdefault(name, []).append(
                    (evt.time_range.start, evt.time_range.end))
            else:
                kernels.append((evt.time_range.start, name))
        elif name.startswith("codec_train_step."):
            host[name] = host.get(name, 0.0) + evt.cpu_time_total / 1e3
    for part in _STEP_PARTS:
        key = f"codec_train_step.{part}"
        if key not in host or (part != "backward"
                               and len(spans.get(key, ())) != 1):
            fail(f"train step: the profile has no single range {key} on "
                 f"the host and the device: {sorted(spans)}")
    fwd = spans["codec_train_step.forward"][0]
    upd = spans["codec_train_step.update"][0]
    windows = {"forward": fwd, "backward": (fwd[1], upd[0]), "update": upd}
    split, by_part = {}, {}
    for part, (lo, hi) in windows.items():
        split[part] = {"host_ms": round(host[f"codec_train_step.{part}"], 3),
                       "device_window_ms": round((hi - lo) / 1e3, 3)}
        by_part[part] = {c: sum(1 for t, n in kernels
                                if k in n and lo <= t < hi)
                         for c, k in _KERNEL_NAMES.items()}
    log(f"train step split (the profiled step, {card}): {json.dumps(split)}")
    log(f"train step kernel launches by part: {json.dumps(by_part)}")
    want = {"lstm_recurrence": 4, "seanet_resblock": 8, "dac_resunit": 0}
    none = dict.fromkeys(want, 0)
    if (by_part["forward"] != want or by_part["backward"] != none
            or by_part["update"] != none):
        fail(f"train step: expected 4 B1 and 8 B2 launches in the forward "
             f"and none in the backward or the update, got {by_part}")
    # each recompute range twice: on the host (its time there and its
    # kernels' device time) and on the device (the span of its kernels)
    ranges = {}
    for evt in prof.key_averages():
        if evt.key not in ("lstm_recurrence.backward",
                           "seanet_resblock.backward"):
            continue
        r = ranges.setdefault(evt.key, {})
        if evt.device_type == DeviceType.CUDA:
            r["device_span_ms"] = round(_device_us(evt) / 1e3, 3)
        else:
            r.update(count=evt.count,
                     host_ms=round(evt.cpu_time_total / 1e3, 3),
                     kernels_ms=round(_device_us(evt) / 1e3, 3))
    log(f"train step recompute inside the backward ({card}): "
        f"{json.dumps(ranges)}")


_KERNEL_GROUPS = (("lstm_recurrence", "lstm_recurrence_kernel"),
                  ("seanet_resblock", "seanet_resblock_kernel"),
                  ("dac_resunit", "dac_resunit_kernel"),
                  ("fft (cuFFT)", "fft"), ("overlap-add (fold)", "col2im"),
                  ("layer_norm", "layer_norm"),
                  ("conv (cuDNN)", "cudnn"), ("conv (cuDNN)", "conv"),
                  ("matmul (cuBLAS)", "xmma_gemm"), ("conv (cuDNN)", "xmma"),
                  ("matmul (cuBLAS)", "gemm"), ("padding", "pad1d"),
                  ("softmax", "softmax"), ("elementwise", "elementwise"),
                  ("reduce", "reduce"))


def _device_us(evt) -> float:
    """Device time of a profiler event, under either attribute name."""
    us = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if us is None else us


def phase_profile(torch, fn, wall_ms, what="roundtrip", top=12):
    """Device time of one run of ``fn`` by kernel (torch.profiler), beside
    its wall time ``wall_ms``; returns the profile (None if it saw no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        # a profiler range (record_function) also shows on the device as
        # the span of its kernels; it is no kernel of its own
        if evt.device_type != DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
            continue
        kernels.append((_device_us(evt) / 1e3, evt.count, evt.key))
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        log("profile: the profiler saw no device time (not measured)")
        return None
    groups = {}
    for ms, _, key in kernels:
        g = next((g for g, pat in _KERNEL_GROUPS if pat in key.lower()),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"profile: device busy {busy:.3f} ms of a {wall_ms:.3f} ms {what} "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); by group (ms): "
        + json.dumps({g: round(v, 3) for g, v in
                      sorted(groups.items(), key=lambda kv: -kv[1])}))
    for ms, count, key in sorted(kernels, reverse=True)[:top]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:100]}")
    return prof


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs the port on a GPU")
    try:
        import audiocodecs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"audiocodecs_tpu_torch not importable ({e}); run from the root "
             "of the repository")
    t0 = time.perf_counter()
    name, card, peaks = phase_card(torch)
    phase_build()
    rows = [phase_lstm(torch, peaks), phase_resblock(torch, peaks),
            phase_packed(torch, peaks), phase_dac_resunit(torch, peaks)]
    phase_main_path(torch, rows)
    phase_dac_path(torch, rows)
    phase_speechtokenizer(torch, rows)
    phase_encodec_stream(torch, rows)
    phase_mimi(torch, rows)
    phase_wavtokenizer(torch, rows)
    phase_encodec_vocos(torch, rows)
    phase_encodec_48k(torch, rows)
    phase_past(torch, rows)
    phase_train(torch, rows, card)
    log(f"total seconds: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"kernels": rows}))
    log(f"card: {card}")
    if "jax" in sys.modules or any(
            m == "audiocodecs_tpu" or m.startswith("audiocodecs_tpu.")
            for m in sys.modules):
        fail("the port pulled in jax or audiocodecs_tpu")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
