"""Streaming (chunked-causal) codec demo, with the port.

Counterpart of ``examples/stream.py``, with the same arguments and output
lines, plus ``--device`` (the card by default): audio goes through Mimi
chunk by chunk with carried state (the Moshi-style low-latency path,
BASELINE config #4), and the streamed tokens are held against the batch
encode. Exits 1 unless every token matches.

    python -m audiocodecs_tpu_torch.examples.stream --frames-per-chunk 2 \\
        --seconds 2
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames-per-chunk", type=int, default=2)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--num-codebooks", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audiocodecs_tpu_torch.models.mimi import Mimi
    from audiocodecs_tpu_torch.utils.audio import example_signal

    codec = Mimi(24000, 24000, num_codebooks=args.num_codebooks,
                 generator=torch.Generator().manual_seed(0),
                 device=args.device)
    frame = codec.frame_size
    chunk_samples = frame * args.frames_per_chunk
    n_chunks = int(args.seconds * 24000) // chunk_samples
    sig = example_signal(24000, args.seconds)[None][
        :, : n_chunks * chunk_samples]

    # batch reference
    batch_toks = codec.sig_to_toks(sig).cpu().numpy()

    enc_state = codec.init_streaming_state(batch=1)
    dec_state = codec.init_streaming_state(batch=1)
    toks_out, wav_out = [], []
    t0 = time.perf_counter()
    for c in range(n_chunks):
        chunk = sig[:, c * chunk_samples : (c + 1) * chunk_samples]
        toks, enc_state = codec.encode_chunk(chunk, enc_state)
        wav, dec_state = codec.decode_chunk(toks, dec_state)
        toks_out.append(toks.cpu().numpy())
        wav_out.append(wav.cpu().numpy())
    dt = time.perf_counter() - t0

    stream_toks = np.concatenate(toks_out, axis=1)
    match = (stream_toks == batch_toks[:, : stream_toks.shape[1]]).mean()
    total = np.concatenate(wav_out, axis=1)
    chunk_ms = chunk_samples / 24000 * 1000
    print(f"streamed {n_chunks} chunks of {chunk_ms:.0f} ms "
          f"({args.frames_per_chunk} frames) in {dt:.2f}s incl. compile")
    print(f"tokens vs batch encode: {match * 100:.1f}% match")
    print(f"decoded {total.shape[1] / 24000:.2f}s of audio")
    return 0 if match == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
