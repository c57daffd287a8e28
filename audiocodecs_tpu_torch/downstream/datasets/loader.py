"""Duration-bucketed, static-shape batching.

The port's copy of ``audiocodecs_tpu/downstream/datasets/loader.py``: host
numpy batches, read by the port's native WAV reader. It replaces the
reference's SpeechBrain ``DynamicBatchSampler`` (reference
``utils.py:137-217``): batches are bucketed by duration and padded to a
small fixed set of time-lengths, so a codec sees a bounded number of
shapes (and a timer measures each shape once).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from audiocodecs_tpu_torch.utils.audio import read_wav

__all__ = ["BucketedLoader", "pad_collate", "length_buckets"]


def length_buckets(max_seconds: float, sample_rate: int, num_buckets: int = 8,
                   multiple: int = 1) -> list[int]:
    """Geometric time-length buckets, rounded up to ``multiple`` samples."""
    lo = max_seconds / num_buckets
    out = []
    for i in range(1, num_buckets + 1):
        t = int(lo * i * sample_rate)
        out.append(int(math.ceil(t / multiple) * multiple))
    return out


def pad_collate(sigs: Sequence[np.ndarray], target_len: int):
    """Pad 1-D signals to ``target_len`` → (``[B, T]``, relative lengths)."""
    B = len(sigs)
    out = np.zeros((B, target_len), np.float32)
    lengths = np.zeros((B,), np.float32)
    for i, s in enumerate(sigs):
        n = min(len(s), target_len)
        out[i, :n] = s[:n]
        lengths[i] = n / target_len
    return out, lengths


class BucketedLoader:
    """Iterate manifest rows as static-shape batches.

    Rows are grouped by duration bucket; each batch's signals are padded to
    the bucket length. ``batch_seconds`` caps total audio per batch (duration
    bucketing à la DynamicBatchSampler), ``batch_size`` caps rows.
    """

    def __init__(
        self,
        rows: Sequence[dict],
        sample_rate: int,
        batch_size: int = 8,
        batch_seconds: Optional[float] = None,
        num_buckets: int = 8,
        multiple: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        read_fn: Callable[[dict], np.ndarray] | None = None,
        drop_last: bool = False,
        num_workers: int = 0,
        prefetch: int = 2,
        sorting: str = "ascending",
    ):
        self.rows = list(rows)
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        self.batch_seconds = batch_seconds
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if sorting not in ("ascending", "descending", "random"):
            raise ValueError(
                f"sorting must be ascending|descending|random, got {sorting}")
        self.sorting = sorting
        self.read_fn = read_fn or self._default_read
        # host-side IO parallelism (reference `dataloader_workers: 4`,
        # tasks/asr.yaml:34): `num_workers` threads read wavs, `prefetch`
        # batches are collated ahead of the device step. Threads (not
        # processes) — the work is file IO, which releases the GIL.
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        max_dur = max(r["duration"] for r in self.rows)
        self.buckets = length_buckets(max_dur * 1.001, sample_rate,
                                      num_buckets, multiple)
        self._epoch = 0

    def _default_read(self, row) -> np.ndarray:
        sig, sr = read_wav(row["wav"])
        if sr != self.sample_rate:
            raise ValueError(
                f"{row['wav']}: sample rate {sr} != loader rate "
                f"{self.sample_rate}; resample during prep or pass a read_fn"
            )
        return sig[0]

    def _bucket_of(self, duration: float) -> int:
        samples = duration * self.sample_rate
        for i, b in enumerate(self.buckets):
            if samples <= b:
                return i
        return len(self.buckets) - 1

    def _plan(self) -> list[tuple[list[dict], int]]:
        """(rows, bucket_target) batch plan for one epoch."""
        order = np.arange(len(self.rows))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        groups: dict[int, list[int]] = {}
        for idx in order:
            b = self._bucket_of(self.rows[idx]["duration"])
            groups.setdefault(b, []).append(int(idx))
        plan = []
        for b, idxs in sorted(groups.items()):
            target = self.buckets[b]
            cap = self.batch_size
            if self.batch_seconds is not None:
                by_dur = max(1, int(self.batch_seconds * self.sample_rate // target))
                cap = min(cap, by_dur)
            for i in range(0, len(idxs), cap):
                chunk = idxs[i : i + cap]
                if self.drop_last and len(chunk) < cap:
                    continue
                plan.append(([self.rows[j] for j in chunk], target))
        # batch ordering (reference `sorting` run-opt): plan is built in
        # ascending bucket order; descending reverses it, random shuffles
        # whole batches (shape grouping is preserved either way)
        if self.sorting == "descending":
            plan.reverse()
        elif self.sorting == "random":
            np.random.default_rng(self.seed + self._epoch).shuffle(plan)
        return plan

    def _collate(self, rows: list[dict], target: int, sigs=None) -> dict:
        if sigs is None:
            sigs = [self.read_fn(r) for r in rows]
        batch_sig, lengths = pad_collate(sigs, target)
        return {
            "ids": [r["ID"] for r in rows],
            "sig": batch_sig,
            "length": lengths,
            "rows": rows,
        }

    def __iter__(self) -> Iterator[dict]:
        plan = self._plan()
        if self.num_workers <= 0:
            for rows, target in plan:
                yield self._collate(rows, target)
            return
        from concurrent.futures import ThreadPoolExecutor

        # flat per-row read futures (no task ever blocks on the pool, so
        # any num_workers is deadlock-free); `prefetch` batches in flight.
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(item):
                rows, target = item
                return rows, target, [pool.submit(self.read_fn, r)
                                      for r in rows]

            pending = []
            it = iter(plan)
            for item in it:
                pending.append(submit(item))
                if len(pending) >= self.prefetch:
                    break
            for item in it:
                rows, target, futs = pending.pop(0)
                pending.append(submit(item))
                yield self._collate(rows, target, [f.result() for f in futs])
            for rows, target, futs in pending:
                yield self._collate(rows, target, [f.result() for f in futs])

    def __len__(self) -> int:
        # upper bound on number of batches (duration-capped batches can
        # hold as little as one row each)
        cap = self.batch_size
        if self.batch_seconds is not None:
            # derive the duration cap from the LARGEST bucket: longer buckets
            # hold the fewest rows per batch, so this keeps the result a true
            # upper bound on batch count
            largest = self.buckets[-1]
            cap = min(cap, max(1, int(self.batch_seconds * self.sample_rate
                                      // largest)))
        return math.ceil(len(self.rows) / max(1, cap)) + len(self.buckets)
