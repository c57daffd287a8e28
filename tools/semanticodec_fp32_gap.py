"""How far two correct fp32 decodes of SemantiCodec part: the port's decode
in float32 against the same decode in float64, on the CPU.

SemantiCodec's DDIM chain amplifies: at t = 981 the first x0 estimate
scales the UNet's error by 1/sqrt(a_t) ≈ 100, and guidance at 2.0 adds to
that. This tool measures what that leaves of fp32 rounding at the output,
on ``chip_smoke.py``'s weights (the port's init, seed 0, published widths)
and its 15 s request (two windows, so the crossfade is in it): tokens from
the fp32 encoder, then both decodes of them at ``--steps`` DDIM steps. It
prints one JSON line: max|sig| and rms of the float64 decode, and the
float32 decode's max and rms distance from it (absolute and as a share of
max|sig|). ``chip_smoke.py`` holds the card against the CPU to the larger
of 1e-4 · max|sig| and this gap (``SEMANTICODEC_FP32_GAP``).

    python3 tools/semanticodec_fp32_gap.py [--steps 2] [--threads 8]

It runs the published widths on the CPU (about 9 TFLOP at two steps, a
third of it in float64): run it on a large host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from audiocodecs_tpu_torch.models.semanticodec import (  # noqa: E402
    SemantiCodec,
)
from chip_smoke import semanticodec_requests  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    codec = SemantiCodec(16000, 16000, device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         ddim_sample_step=args.steps)
    sig = semanticodec_requests()[1]
    toks = codec.sig_to_toks(sig)
    y32 = codec.toks_to_sig(toks).double()
    y64 = codec.double().toks_to_sig(toks)
    assert y64.dtype == torch.float64
    scale = float(y64.abs().max())
    gap = (y32 - y64).abs()
    print(json.dumps({
        "steps": args.steps, "sig_shape": list(sig.shape),
        "max_abs_sig": scale, "rms_sig": float(y64.pow(2).mean().sqrt()),
        "gap_max": float(gap.max()), "gap_rms": float(gap.pow(2).mean()
                                                     .sqrt()),
        "gap_max_rel": float(gap.max()) / scale,
        "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main()
