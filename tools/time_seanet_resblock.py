#!/usr/bin/env python3
"""Time the one-pass form of the port's SEANet residual block (B2's
``precision="default"``) of one checkout on one NVIDIA GPU.

    python3 tools/time_seanet_resblock.py [ROOT] [--shapes encodec,extra]
        [--forms default_f32,default_bf16] [--check] [--tiers] [--spans]

imports ``audiocodecs_tpu_torch`` from ROOT (default: this repository) and
times its ``seanet_resblock`` on fp32 and on bf16 operands on weights
packed once, at the block shapes of ``chip_smoke.py``: EnCodec-24k's four
decoder blocks at B = 8 x 10 s (``RESBLOCK_SHAPES``) or the two odd shapes
of ``RESBLOCK_EXTRA`` (``extra``: T off the 16-byte rows, the widest tile).
Each shape gets three times: ``ms``, the median of CUDA-event timings of
one call (``chip_smoke.cuda_ms``, as ``chip_smoke.py`` times it: the
wrapper's host time before the launch counts when the card waits for
it); ``queued_ms``, 20 calls back to back between two events, over 20;
and ``device_ms``, the kernel's own device time a call (torch.profiler,
after the spin launches ``chip_smoke.phase_profile`` makes).
``--check`` holds every launch to its plain version first, one rounding
point at a time (``default_errors``); ``--tiers`` also times the warm
roundtrips of the EnCodec-style tiers that run the form (EnCodec-24k and
PAST-16k balanced at B = 8 x 10 s) and certify's one-pass encode of
EnCodec-24k at B = 4 x 10 s, with its certified share and real token
match (seeded noise, seeded random weights).

``--spans`` instead times the kernel's roles: it copies ROOT's package
into ROOT's ``_archive/spans/`` (listed in ``.gitignore``), adds
``clock64`` spans to the copy's one-pass kernel (each role's waits and
steps, summed over blocks by one thread of the consumer and one of the
transform warps into a device array), builds and imports the copy, and
prints the cycles an item of each span at each shape. The spans cost the
kernel some time of their own; they show shares, not the kernel's time.

``chip_smoke.py`` times only its own checkout; this script lets a parent
checkout and a change (each a ROOT, each building its kernels in its own
tree) be timed in turns in one run on one card. The last line is one JSON
object with the card and every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORMS = {"default_f32": "float32", "default_bf16": "bfloat16"}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def time_blocks(torch, smoke, form, shapes, check):
    """Kernel ms of ``form`` at each (B, C, T) of ``shapes``, with the
    instance's budget (``seanet_resblock_info``), its bound and, with
    ``check``, its errors as shares of their limits."""
    from audiocodecs_tpu_torch.nn.layers import pad1d
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        default_errors, pack_resblock_weights, seanet_resblock,
        seanet_resblock_info, seanet_resblock_stages)

    dtype = getattr(torch, FORMS[form])
    gen = torch.Generator().manual_seed(15)
    rows = []
    for B, C, T in shapes:
        x, w = smoke._resblock_inputs(torch, gen, B, C, T, "cuda")
        halo = pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2]
        args = [t.to(dtype).contiguous() for t in (x, halo, *w)]
        row = {"B": B, "C": C, "T": T}
        with torch.inference_mode():
            packed = pack_resblock_weights(w[0], w[2], w[4], "default")
            if check:
                out, h2, k3 = seanet_resblock_stages(*args, packed=packed)
                errs = default_errors(out, h2, k3, *args)
                same = torch.equal(out, seanet_resblock(
                    *args, packed=packed, precision="default"))
                row.update({k: errs[k] for k in (
                    "k3_ratio", "h2_ratio", "h2_differ", "tail_ratio")},
                    ok=errs["ok"] and same)
                del out, h2, k3

            def call():
                return seanet_resblock(*args, packed=packed,
                                       precision="default")

            row["ms"] = smoke.cuda_ms(torch, call, reps=10)
            row["queued_ms"] = smoke.cuda_ms(
                torch, lambda: [call() for _ in range(20)], reps=5) / 20
            row["device_ms"] = device_ms(torch, smoke, call)
        Hc = C // 2
        flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
        esize = args[0].element_size()
        nbytes = (2 * B * C * T + 2 * B * C) * esize + 2 * (
            3 * C * Hc + Hc * C + C * C) + esize * (Hc + 2 * C)
        row["bound_ms"], row["bound_by"] = smoke.bound(
            flops, nbytes, (smoke.BF16_PEAK, 3.35e12))
        row.update(seanet_resblock_info(C, Hc, "default", dtype))
        rows.append(row)
        del x, w, args, packed
    return rows


def device_ms(torch, smoke, fn, calls=5):
    """The block kernel's device time a call of ``fn`` (torch.profiler),
    None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(smoke.PROFILE_WARMUP_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [smoke._device_us(e) for e in prof.key_averages()
          if "seanet_resblock_mma_kernel" in e.key]
    return sum(us) / calls / 1e3 if us and sum(us) > 0 else None


# clock64 spans added to the one-pass kernel's source (``--spans``): the
# text each is inserted at, and what goes there. SPAN(i) adds the cycles
# since the previous span to slot i; slot 4 sums the transform's whole
# walk, 20 the consumer's, 6 and 22 count their items.
_SPAN_SITES = [
    ("using namespace sm90;\n\nconstexpr int kTile", "using namespace sm90;\n"
     "__device__ unsigned long long acx_spans[32];\n"
     "#define SPAN_T0 long long _t0 = clock64();\n"
     "#define SPAN(i) { long long _t1 = clock64(); if (lane0) atomicAdd("
     "&acx_spans[i], (unsigned long long)(_t1 - _t0)); _t0 = _t1; }\n"
     "constexpr int kTile"),
    ("  __syncwarp();\n\n  for (int n = 0; n < my; ++n) {\n    int b, t0;",
     "  __syncwarp();\n  const bool lane0 = xt == 32;\n"
     "  const long long _tstart = clock64();\n  SPAN_T0\n"
     "  for (int n = 0; n < my; ++n) {\n    int b, t0;"),
    ("    mbar_wait(&opr.empty[so], ((n / L::SO) & 1) ^ 1);\n",
     "    SPAN(5) mbar_wait(&opr.empty[so], ((n / L::SO) & 1) ^ 1);"
     " SPAN(0)\n"),
    ("        mbar_wait(&rr.full[s], (u / rr.stages) & 1);\n",
     "        SPAN(5) mbar_wait(&rr.full[s], (u / rr.stages) & 1); SPAN(1)\n"),
    ("      // the halo rows: channel c = r RC + e % RC, row j = e / RC\n",
     "      SPAN(2)\n"),
    ("      if (tma) mbar_arrive_warp(&rr.empty[s]);\n    }\n"
     "    fence_proxy_async();\n    mbar_arrive_warp(&opr.full[so]);\n  }\n}",
     "      SPAN(7) if (tma) mbar_arrive_warp(&rr.empty[s]);\n    }\n"
     "    fence_proxy_async();\n    mbar_arrive_warp(&opr.full[so]); SPAN(3)\n"
     "  }\n  if (lane0) { atomicAdd(&acx_spans[4], (unsigned long long)("
     "clock64() - _tstart)); atomicAdd(&acx_spans[6], "
     "(unsigned long long)my); }\n}"),
    ("  int pend_b = -1, pend_t0 = 0;",
     "  const bool lane0 = threadIdx.x == 0;\n"
     "  const long long _tstart = clock64();\n  SPAN_T0\n"
     "  int pend_b = -1, pend_t0 = 0;"),
    ("    mbar_wait(&opr.full[so], (n / L::SO) & 1);\n    __syncwarp();\n",
     "    SPAN(19) mbar_wait(&opr.full[so], (n / L::SO) & 1);\n"
     "    __syncwarp(); SPAN(10)\n"),
    ("    if (pend_b >= 0) {  // the previous item's last pass",
     "    SPAN(11) if (pend_b >= 0) {  // the previous item's last pass"),
    ("    for (int p = 0; p < w.p1n; ++p) {\n      if constexpr (L::RES) {",
     "    SPAN(21)\n    for (int p = 0; p < w.p1n; ++p) {\n"
     "      if constexpr (L::RES) {"),
    ("    fence_proxy_async();\n    consumer_sync();  // h2 complete",
     "    SPAN(12) fence_proxy_async();\n"
     "    consumer_sync();  // h2 complete"),
    ("    // per pass of N2 output channels o:", "    SPAN(13)\n"
     "    // per pass of N2 output channels o:"),
    ("      if (p == w.p2n - 1) mbar_arrive_warp(&opr.empty[so]);",
     "      SPAN(14) if (p == w.p2n - 1) mbar_arrive_warp(&opr.empty[so]);"),
    ("      consumer_sync();  // the pass's outputs complete\n",
     "      SPAN(15) consumer_sync();  // the pass's outputs complete\n"
     "      SPAN(17)\n"),
    ("    pend_b = b, pend_t0 = t0;\n  }\n",
     "    SPAN(18) pend_b = b, pend_t0 = t0;\n"
     "    if (lane0) atomicAdd(&acx_spans[22], 1ull);\n  }\n"
     "  if (lane0) atomicAdd(&acx_spans[20], (unsigned long long)(clock64()"
     " - _tstart));\n"),
]
_SPAN_NAMES = {
    0: "x.wait_op_stage", 1: "x.wait_raw_tile", 2: "x.main_units",
    7: "x.halo_rows", 3: "x.hand_over", 5: "x.other", 4: "x.total",
    10: "c.wait_op_stage", 11: "c.issue_k3", 21: "c.store_previous",
    12: "c.wait_k3_h2_epilogue", 13: "c.h2_barrier", 14: "c.second_gemm",
    15: "c.stage_out", 17: "c.barriers", 18: "c.store_inline",
    19: "c.other", 20: "c.total"}
_SPAN_READ = """
ACX_EXPORT int seanet_resblock_spans(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, mma::acx_spans,
                                       sizeof(unsigned long long) * 32);
  if (e == cudaSuccess && reset) {
    unsigned long long z[32] = {};
    e = cudaMemcpyToSymbol(mma::acx_spans, z, sizeof(z));
  }
  return e;
}
"""


def span_copy(root: Path) -> Path:
    """ROOT's package copied into ROOT/_archive/spans with the spans added
    to its one-pass kernel; returns the copy's root."""
    import shutil

    dst = root / "_archive" / "spans"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "audiocodecs_tpu_torch",
                    dst / "audiocodecs_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "audiocodecs_tpu_torch" / "csrc" / "seanet_resblock.cu"
    src = cu.read_text()
    for at, new in _SPAN_SITES:
        if src.count(at) != 1:
            raise SystemExit(f"--spans: the kernel source changed at {at!r}")
        src = src.replace(at, new)
    cu.write_text(src + _SPAN_READ)
    return dst


def time_spans(torch, smoke, form, shapes):
    """Cycles an item of each span of the instrumented kernel, and each
    role's cycles a block and launch."""
    import ctypes

    from audiocodecs_tpu_torch.nn.layers import pad1d
    from audiocodecs_tpu_torch.ops import seanet_resblock as sr

    lib = sr._lib()
    lib.seanet_resblock_spans.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    buf = (ctypes.c_ulonglong * 32)()
    dtype = getattr(torch, FORMS[form])
    gen = torch.Generator().manual_seed(15)
    rows, reps = [], 3
    for B, C, T in shapes:
        x, w = smoke._resblock_inputs(torch, gen, B, C, T, "cuda")
        halo = pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2]
        args = [t.to(dtype).contiguous() for t in (x, halo, *w)]
        with torch.inference_mode():
            packed = sr.pack_resblock_weights(w[0], w[2], w[4], "default")
            for n in (2, reps):  # warm-up, then the counted launches
                for _ in range(n):
                    sr.seanet_resblock(*args, packed=packed,
                                       precision="default")
                torch.cuda.synchronize()
                lib.seanet_resblock_spans(buf, 1)
        v = [float(u) / reps for u in buf]
        info = sr.seanet_resblock_info(C, C // 2, "default", dtype)
        blocks = min(B * -(-T // 64), info["blocks_per_sm"] * torch.cuda
                     .get_device_properties(0).multi_processor_count)
        row = {"B": B, "C": C, "T": T, "blocks": blocks}
        row.update({name: round(v[i] / (v[22] if i >= 10 else v[6]), 1)
                    for i, name in _SPAN_NAMES.items()})
        row["x.cycles_a_block"] = round(v[4] / blocks)
        row["c.cycles_a_block"] = round(v[20] / blocks)
        rows.append(row)
        del x, w, args, packed
    return rows


def time_tiers(torch, smoke, root):
    """Warm roundtrip ms of the EnCodec-style tiers that launch the form,
    and certify's one-pass encode with its certified share."""
    import numpy as np

    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    rng = np.random.default_rng(16)
    out = {}
    for name, cls, family, sr in (("encodec_24k", Encodec, "encodec", 24000),
                                  ("past_16k", PAST, "past", 16000)):
        tier = cls(sr, sr, num_codebooks=8, device="cuda",
                   generator=torch.Generator().manual_seed(0),
                   **apply_serving_preset(family))
        sig = torch.as_tensor(smoke._noise(rng, [(8, 10 * sr)])[0],
                              device="cuda")
        with torch.inference_mode():
            out[f"{name}_balanced_b8"] = smoke.cuda_ms(
                torch, lambda: tier.roundtrip(sig), reps=5)
        del tier, sig
    sys.path.insert(0, str(Path(root) / "tools"))
    try:
        import certify_torch
    finally:
        sys.path.pop(0)
    from audiocodecs_tpu_torch.quant.certify import certify_codec

    exact = certify_torch.build("encodec", "cuda")
    fast = certify_torch.build("encodec", "cuda", encode_precision="default")
    sig = certify_torch.signal(smoke.CERTIFY_B, smoke.CERTIFY_SECONDS, 24000)
    with torch.inference_mode():
        res = certify_codec(exact, fast, sig)
        sig_dev = torch.as_tensor(sig, device="cuda")
        out["certify_encode_ms"] = smoke.cuda_ms(
            torch, lambda: fast.sig_to_toks(sig_dev), reps=5)
    out["certify"] = res
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(REPO))
    ap.add_argument("--shapes", default="encodec")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--tiers", action="store_true")
    ap.add_argument("--spans", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(span_copy(root) if args.spans else root))
    smoke = _smoke()
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_seanet_resblock: needs a CUDA card")
    from audiocodecs_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {_build.__file__}", flush=True)
    sets = {"encodec": smoke.RESBLOCK_SHAPES, "extra": smoke.RESBLOCK_EXTRA}
    result = {"root": args.root, "card": card, "forms": {}}
    if args.spans:
        result["spans"] = {}
        for form in args.forms.split(","):
            for name in args.shapes.split(","):
                rows = time_spans(torch, smoke, form, sets[name])
                result["spans"][f"{form} {name}"] = rows
                for r in rows:
                    print(f"spans {form}: {json.dumps(r)}", flush=True)
        print(json.dumps(result))
        return
    for form in args.forms.split(","):
        result["forms"][form] = per_set = {}
        for name in args.shapes.split(","):
            rows = time_blocks(torch, smoke, form, sets[name], args.check)
            total = math.fsum(r["ms"] for r in rows)
            per_set[name] = {"ms": total, "per_shape": rows}
            dev = [r["device_ms"] or float("nan") for r in rows]
            per_set[name]["device_ms"] = math.fsum(dev)
            print(f"{form} {name}: {total:.4f} ms "
                  f"({', '.join('%.4f' % r['ms'] for r in rows)}); device "
                  f"{math.fsum(dev):.4f} ms "
                  f"({', '.join('%.4f' % d for d in dev)})"
                  + ("" if not args.check else " ok=" + str(
                      all(r["ok"] for r in rows))), flush=True)
            for r in rows:
                print(f"  {json.dumps(r)}", flush=True)
    if args.tiers:
        result["tiers"] = time_tiers(torch, smoke, root)
        print(f"tiers: {json.dumps(result['tiers'])}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
