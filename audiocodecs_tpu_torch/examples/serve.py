"""Codec serving loop with dynamic batching, on the card by default.

The port's twin of ``examples/serve.py``: requests arrive one at a time
with arbitrary lengths; each is padded up to one of a few LENGTH BUCKETS,
and one collector thread a bucket groups its requests into batches of up
to ``max_batch`` (or what arrived within ``max_wait_ms``), pads the batch
to ``max_batch`` rows and runs the codec's ``roundtrip`` on it. Fixed
shapes a bucket keep the kernels' launch shapes, and the fused units'
packed weights, the same from batch to batch.

Port-specific rules:

* One roundtrip at a time, under a lock, on one CUDA stream (the stream
  current when the server was made). The recurrence kernel is a
  cooperative launch whose blocks wait on each other, so two on separate
  streams could stall the card; the fused units pack their weights on their
  first forward. The server warms the codec (builds and loads every kernel,
  packs the weights) before its threads start. The copy back to the host
  runs outside the lock, so the next batch is enqueued meanwhile.
* A failure in a batch goes to every request of that batch: its
  :meth:`Reply.get` raises it. The worker goes on serving.

The codec is built in its family's serving tier
(:func:`audiocodecs_tpu_torch.serving.apply_serving_preset`, ``--quality``
exact|balanced|fast, balanced by default, as the reference's ``main``).

Run (synthesizes its own request stream; seeded random weights):

    python -m audiocodecs_tpu_torch.examples.serve --codec bigcodec
    python -m audiocodecs_tpu_torch.examples.serve --codec encodec --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import queue
import threading
import time

import numpy as np
import torch

__all__ = ["CodecServer", "Reply", "main"]


class Reply:
    """One request's answer: :meth:`get` waits for the waveform ``[T]``
    (numpy, float32) or raises the error of the batch it ran in. After it
    ran, ``batch`` is the padded ``[max_batch, bucket]`` input of that
    batch and ``row`` this request's row in it; ``submitted`` and ``done``
    are ``time.perf_counter()`` stamps."""

    def __init__(self, n_samples: int):
        self.n_samples = n_samples
        self.submitted = time.perf_counter()
        self.done = None
        self.batch = None
        self.row = None
        self._q: queue.Queue = queue.Queue(1)

    def _deliver(self, value) -> None:
        self.done = time.perf_counter()
        self._q.put(value)

    def get(self, timeout=None) -> np.ndarray:
        value = self._q.get(timeout=timeout)
        self._q.put(value)  # a second get() sees the same answer
        if isinstance(value, BaseException):
            raise value
        return value


class CodecServer:
    """Dynamic-batching frontend over a codec's roundtrip."""

    def __init__(self, codec, buckets_s=(1.0, 2.0, 5.0, 10.0),
                 max_batch: int = 8, max_wait_ms: float = 5.0):
        self.codec = codec
        self.sr = codec.config.sample_rate
        self.buckets = [int(b * self.sr) for b in sorted(buckets_s)]
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.queues = {b: queue.Queue() for b in self.buckets}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        dev = codec.device
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        # build the kernels and pack the fused weights before the threads
        with self._on_stream():
            codec.roundtrip(np.zeros((max_batch, self.buckets[0]),
                                     np.float32))
        self._threads = [
            threading.Thread(target=self._worker, args=(b,), daemon=True)
            for b in self.buckets
        ]
        for t in self._threads:
            t.start()

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def submit(self, wav: np.ndarray) -> Reply:
        """Enqueue one mono request ``[T]``; returns its :class:`Reply`.

        Requests longer than the largest bucket are rejected: truncating
        would deliver fewer samples than asked for (route long audio through
        :func:`audiocodecs_tpu_torch.utils.windowed.windowed_reconstruct`).
        """
        T = wav.shape[0]
        if T > self.buckets[-1]:
            raise ValueError(
                f"request of {T} samples exceeds the largest bucket "
                f"({self.buckets[-1]}); use windowed_reconstruct for "
                f"long audio or configure a larger bucket")
        bucket = next(b for b in self.buckets if T <= b)
        reply = Reply(T)
        self.queues[bucket].put((wav, reply))
        return reply

    def _collect(self, q: queue.Queue):
        """The next batch of a bucket's queue, or None when stopped."""
        while not self._stop.is_set():
            try:
                first = q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(q.get(timeout=remaining))
                except queue.Empty:
                    break
            return batch
        return None

    def _worker(self, bucket: int):
        q = self.queues[bucket]
        while (batch := self._collect(q)) is not None:
            try:
                # pad the batch to max_batch rows: one launch shape a bucket
                sigs = np.zeros((self.max_batch, bucket), np.float32)
                for i, (wav, _) in enumerate(batch):
                    sigs[i, : wav.shape[0]] = wav
                with self._lock, self._on_stream():
                    out = self.codec.roundtrip(sigs)
                with self._on_stream():
                    rec = out.cpu().numpy()
            except Exception as e:  # every request of the batch gets it
                for _, reply in batch:
                    reply._deliver(e)
                continue
            for i, (_, reply) in enumerate(batch):
                reply.batch, reply.row = sigs, i
                reply._deliver(rec[i, : reply.n_samples])

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--codec", default="encodec")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    p.add_argument("--quality", default="balanced",
                   choices=("exact", "balanced", "fast"),
                   help="serving tier of the family's decoder")
    args = p.parse_args(argv)

    from audiocodecs_tpu_torch.models import get_codec_class
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    preset = apply_serving_preset(args.codec, args.quality)
    if preset:
        print(f"serving preset[{args.codec}]: {preset}")
    cls = get_codec_class(args.codec)
    sr = getattr(cls, "DEFAULT_ORIG_SR", 24000)
    codec = cls(sr, sr, device=args.device, **preset)
    server = CodecServer(codec, max_batch=args.batch)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    replies = []
    total_audio = 0.0
    try:
        for i in range(args.requests):
            dur = float(rng.uniform(0.5, 8.0))
            total_audio += dur
            t = np.arange(int(dur * sr)) / sr
            wav = np.sin(2 * np.pi * (200 + 50 * i) * t).astype(np.float32)
            replies.append(server.submit(wav))
        recs = [r.get(timeout=600) for r in replies]
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    for reply, rec in zip(replies, recs):
        if rec.shape != (reply.n_samples,) or not np.isfinite(rec).all():
            raise RuntimeError(f"bad reply: shape {rec.shape} for "
                               f"{reply.n_samples} samples")
    lat = np.array([r.done - r.submitted for r in replies]) * 1e3
    print(f"{args.requests} requests ({total_audio:.1f}s audio) served in "
          f"{wall:.2f}s on {codec.device} -> {total_audio / wall:.1f}x "
          f"real-time; latency p50 {np.percentile(lat, 50):.1f} ms, p90 "
          f"{np.percentile(lat, 90):.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
