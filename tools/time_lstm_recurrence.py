#!/usr/bin/env python3
"""Time the port's LSTM recurrence kernel of one checkout on one NVIDIA GPU.

    python3 tools/time_lstm_recurrence.py [ROOT] [--label NAME]

imports ``audiocodecs_tpu_torch`` from ROOT (default: this repository) and
times its ``lstm_recurrence`` with this repository's ``chip_smoke.time_lstm``
at the shapes ``chip_smoke.py`` phase 3 times (``LSTM_TIMED``, each at B and
at B = 1). ``chip_smoke.py`` times only its own checkout; this script lets a
parent checkout and a change be timed in turns in one run on one card. The
last line is one JSON object with the card and every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(REPO))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_lstm_recurrence: needs a CUDA card")
    from audiocodecs_tpu_torch.ops import lstm_recurrence as ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {ops.__file__}", flush=True)
    rows = []
    for T, B, H in smoke.LSTM_TIMED:
        row = smoke.time_lstm(torch, ops, T, B, H)
        print(f"{args.label} T={T} B={B} H={H}: {smoke._lstm_times(row)} "
              f"max_abs_err={row['max_abs_err']:.3e}", flush=True)
        rows.append(row)
    print(json.dumps({"label": args.label, "card": card, "shapes": rows}))


if __name__ == "__main__":
    main()
