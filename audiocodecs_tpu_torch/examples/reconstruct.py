"""Quickstart CLI: waveform → tokens → waveform, with the port.

Counterpart of ``examples/reconstruct.py`` (the reference quickstart,
reference ``README.md:69-80``: build a codec, ``sig_to_toks``,
``toks_to_sig``), with the same arguments and output lines, plus
``--device`` (the card by default). EnCodec, the default, runs the LSTM and
SEANet-block kernels on the card.

    python -m audiocodecs_tpu_torch.examples.reconstruct --out /tmp/rec.wav
    python -m audiocodecs_tpu_torch.examples.reconstruct --in speech.wav \\
        --num-codebooks 4 --device cpu
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--codec", default="encodec",
                   help="registry name (encodec, ...)")
    p.add_argument("--in", dest="inp", default=None,
                   help="input wav (default: synthetic)")
    p.add_argument("--out", default="reconstruction.wav")
    p.add_argument("--num-codebooks", type=int, default=8)
    p.add_argument("--sample-rate", type=int, default=24000,
                   help="I/O sample rate (resampled to the codec's native "
                        "rate)")
    p.add_argument("--checkpoint", default=None,
                   help="params .npz in the reference package's layout "
                        "(default: random init)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audiocodecs_tpu_torch.models import get_codec_class
    from audiocodecs_tpu_torch.utils.audio import (
        example_signal,
        read_wav,
        write_wav,
    )

    if args.inp:
        sig_np, sr = read_wav(args.inp)
        sig_np = sig_np[:1]  # mono
        args.sample_rate = sr
    else:
        sig_np = example_signal(args.sample_rate, 1.0)[None]

    cls = get_codec_class(args.codec)
    codec = cls(sample_rate=args.sample_rate,
                num_codebooks=args.num_codebooks, device=args.device)
    if args.checkpoint:
        from audiocodecs_tpu_torch.params import from_jax_params
        from audiocodecs_tpu_torch.utils.checkpoint import load_params

        codec.load_state_dict(
            from_jax_params(load_params(args.checkpoint), codec), strict=True)

    sig = torch.from_numpy(np.ascontiguousarray(sig_np, np.float32)).to(
        codec.device)
    t0 = time.perf_counter()
    toks = codec.sig_to_toks(sig)
    rec = codec.toks_to_sig(toks)
    rec_np = rec.cpu().numpy()
    dt = time.perf_counter() - t0

    write_wav(args.out, rec_np, args.sample_rate)
    dur = sig_np.shape[-1] / args.sample_rate
    print(
        f"{args.codec}: {sig_np.shape} @ {args.sample_rate} Hz -> tokens "
        f"{tuple(toks.shape)} -> {rec_np.shape} ({dt:.2f}s incl. compile, "
        f"{dur / dt:.1f}x realtime)"
    )
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
