"""Per-frame token-safety certification of the one-pass encoder, on the port.

The PyTorch/CUDA twin of ``tools/certify_high.py``: runs the same codec's
encoder twice, exact fp32 and at one bf16 pass (``encode_precision=
"default"``, the reference's ``ACX_CONV_PRECISION=default``: every encoder
conv and fused SEANet block on bf16-rounded operands with fp32 sums), and
applies the sound RVQ certificate (:mod:`audiocodecs_tpu_torch.quant.
certify`): a certified frame PROVABLY yields the exact encoder's tokens;
the real tokens of both encoders are compared as well.

    python tools/certify_torch.py [--codec encodec|mimi] [--batch 4]
                                  [--seconds 10] [--prec default]
                                  [--device cpu]

Runs on the card unless ``--device`` says otherwise; weights are seeded
random (generator seed 0), the signal the reference tool's (sines at
180 + 60 b Hz plus noise from ``default_rng(0)``). Prints one JSON line:
{"certified": f, "equal": f, "mismatch": f, "real_token_match": f,
"max_delta": d, ...}; exits 1 if a certified frame's real tokens differ.
``--prec high`` (three bf16 passes) has no counterpart on the card and
raises ``ValueError``; DAC's one-pass encoder is not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def signal(batch: int, seconds: float, sr: int):
    """The reference tool's test signal: [batch, T] float32."""
    import numpy as np

    T = int(sr * seconds)
    rng = np.random.default_rng(0)
    t = np.arange(T) / float(sr)
    return np.stack([
        (0.5 * np.sin(2 * np.pi * (180 + 60 * b) * t)
         + 0.1 * rng.standard_normal(T)).astype(np.float32)
        for b in range(batch)])


def build(codec: str, device=None, **kw):
    """The codec at 24 kHz, 8 codebooks, encode mode, seeded weights."""
    import torch

    from audiocodecs_tpu_torch.models import get_codec_class

    if codec not in ("encodec", "mimi"):
        raise NotImplementedError(
            f"--codec {codec}: the port certifies encodec and mimi (DAC's "
            "one-pass encoder is not ported)")
    cls = get_codec_class(codec)
    return cls(24000, 24000, mode="encode", num_codebooks=8, device=device,
               generator=torch.Generator().manual_seed(0), **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--codec", default="encodec")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--prec", default="default")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    args = p.parse_args(argv)
    if args.prec != "default":
        raise ValueError(
            f"--prec {args.prec}: the card has no three-pass bf16 conv; the "
            "port's reduced-precision encoder is 'default' (one bf16 pass)")

    import torch

    from audiocodecs_tpu_torch.quant.certify import certify_codec

    exact = build(args.codec, args.device)
    fast = build(args.codec, args.device, encode_precision=args.prec)
    sig = signal(args.batch, args.seconds, 24000)
    with torch.inference_mode():
        res = certify_codec(exact, fast, sig)
    dev = exact.device
    print(json.dumps({
        "codec": args.codec, "prec": args.prec, **res,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}))
    return 1 if res["certified_but_real_mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())
