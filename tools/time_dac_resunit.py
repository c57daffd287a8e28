#!/usr/bin/env python3
"""Time the one-pass form of the port's DAC residual unit (B4's
``precision="default"``) of one checkout on one NVIDIA GPU.

    python3 tools/time_dac_resunit.py [ROOT] [--shapes dac,bigcodec]
        [--forms default_poly_bf16,...] [--check] [--tiers]

imports ``audiocodecs_tpu_torch`` from ROOT (default: this repository) and
times its ``dac_resunit`` in each one-pass instance (fp32 or bf16 operands
x the sin or the polynomial snake) on weights packed once, at the unit
shapes of ``chip_smoke.py``: DAC-44.1k's six (``DAC_UNIT_SHAPES``),
BigCodec-16k's nine (``DAC_UNIT_BIGCODEC``) or the four odd shapes of
``DAC_UNIT_EXTRA`` (``extra``). Each time is the
median of CUDA-event timings (``chip_smoke.cuda_ms``). ``--check`` holds
every launch to its plain version first (``default_errors``); ``--tiers``
also times the warm roundtrips of the serving tiers that run the form
(DAC-44.1k fast at B = 1, throughput at B = 4 and 8, BigCodec-16k balanced
at B = 8, all x 10 s of seeded noise on seeded random weights).

``chip_smoke.py`` times only its own checkout; this script lets a parent
checkout and a change (each a ROOT, each building its kernels in its own
tree) be timed in turns in one run on one card. The last line is one JSON object with the card and every number.
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
ONE_PASS = ("default_f32", "default_poly_f32", "default_bf16",
            "default_poly_bf16")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def time_units(torch, smoke, form, shapes, check):
    """Kernel ms of ``form`` at each (B, C, T, d) of ``shapes`` and their
    sum, with the occupancy of the instance and its bound."""
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_info, dac_resunit_stages, default_errors,
        pack_resunit_weights)

    precision, poly, dt = smoke._NEW_FORMS[form]
    dtype = getattr(torch, dt)
    gen = torch.Generator().manual_seed(5)
    rows = []
    for B, C, T, d in shapes:
        x, weights = smoke._unit_inputs(torch, gen, B, C, T, "cuda")
        x, weights = x.to(dtype), [w.to(dtype) for w in weights]
        kw = dict(precision=precision, snake_poly=poly)
        row = {"B": B, "C": C, "T": T, "d": d}
        with torch.inference_mode():
            packed = pack_resunit_weights(weights[0], weights[3], precision)
            if check:
                out, h2 = dac_resunit_stages(x, *weights, d, snake_poly=poly,
                                             packed=packed)
                errs = default_errors(out, h2, x, *weights, d, poly)
                row.update(h2_ratio=errs["h2_ratio"],
                           tail_ratio=errs["tail_ratio"], ok=errs["ok"])
                del out, h2
            row["ms"] = smoke.cuda_ms(torch, lambda: dac_resunit(
                x, *weights, d, packed=packed, **kw), reps=10)
        flops = 2.0 * B * T * 8 * C * C
        nbytes = (2 * B * C * T * x.element_size() + 2 * 8 * C * C
                  + 4 * C * x.element_size())
        row["bound_ms"], row["bound_by"] = smoke.bound(
            flops, nbytes, (smoke.BF16_PEAK, 3.35e12))
        row.update(dac_resunit_info(C, d, precision, poly, dtype))
        rows.append(row)
        del x, weights, packed
    return rows


def time_tiers(torch, smoke):
    """Warm roundtrip ms of the tiers that launch the one-pass form."""
    import numpy as np

    from audiocodecs_tpu_torch.models.bigcodec import BigCodec
    from audiocodecs_tpu_torch.models.dac import DAC
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    rng = np.random.default_rng(13)
    out = {}
    sr = 44100
    gen = torch.Generator().manual_seed(0)
    state = {k: v.detach().cpu() for k, v in DAC(
        sr, sr, num_codebooks=9, device="cuda",
        generator=gen).state_dict().items()}
    for name, quality, B in (("dac_44k_fast_b1", "fast", 1),
                             ("dac_44k_throughput_b4", "balanced", 4),
                             ("dac_44k_throughput_b8", "balanced", 8)):
        tier = DAC(sr, sr, num_codebooks=9, device="cuda", state_dict=state,
                   **apply_serving_preset("dac", quality, B))
        sig = torch.as_tensor(smoke._noise(rng, [(B, 10 * sr)])[0],
                              device="cuda")
        out[name] = smoke.cuda_ms(torch, lambda: tier.roundtrip(sig),
                                  reps=5)
        del tier, sig
    sr = 16000
    tier = BigCodec(sr, sr, latent=False, device="cuda",
                    generator=torch.Generator().manual_seed(0),
                    **apply_serving_preset("bigcodec"))
    sig = torch.as_tensor(smoke._noise(rng, [(8, 10 * sr)])[0],
                          device="cuda")
    out["bigcodec_16k_balanced_b8"] = smoke.cuda_ms(
        torch, lambda: tier.roundtrip(sig), reps=5)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(REPO))
    ap.add_argument("--shapes", default="dac,bigcodec")
    ap.add_argument("--forms", default=",".join(ONE_PASS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--tiers", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    smoke = _smoke()
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_dac_resunit: needs a CUDA card")
    from audiocodecs_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {_build.__file__}", flush=True)
    sets = {"dac": smoke.DAC_UNIT_SHAPES, "bigcodec": smoke.DAC_UNIT_BIGCODEC,
            "extra": smoke.DAC_UNIT_EXTRA}
    result = {"root": args.root, "card": card, "forms": {}}
    for form in args.forms.split(","):
        result["forms"][form] = per_set = {}
        for name in args.shapes.split(","):
            rows = time_units(torch, smoke, form, sets[name], args.check)
            total = math.fsum(r["ms"] for r in rows)
            per_set[name] = {"ms": total, "per_shape": rows}
            print(f"{form} {name}: {total:.4f} ms "
                  f"({', '.join('%.4f' % r['ms'] for r in rows)})"
                  + ("" if not args.check else " ok=" + str(
                      all(r["ok"] for r in rows))), flush=True)
            for r in rows:
                print(f"  {json.dumps(r)}", flush=True)
    if args.tiers:
        result["tiers"] = time_tiers(torch, smoke)
        print(f"tiers: {json.dumps(result['tiers'])}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
