"""Metric accumulation protocol.

The port's copy of ``audiocodecs_tpu/downstream/metrics/base.py``.

Same append/summarize/clear lifecycle as the reference's SpeechBrain
``MetricStats`` subclasses (e.g. reference ``metrics/utmos.py:30-54``), without
the SpeechBrain dependency: a metric is a function of (hyp, ref, ...) batches;
the stats object accumulates per-utterance scores keyed by ID.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["MetricStats"]


class MetricStats:
    def __init__(self, metric: Callable, name: str = "metric"):
        self.metric = metric
        self.name = name
        self.clear()

    def clear(self):
        self.ids: list = []
        self.scores: list = []

    def append(self, ids, *args, **kwargs):
        scores = self.metric(*args, **kwargs)
        scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
        if len(scores) != len(ids):
            raise ValueError(f"{self.name}: {len(scores)} scores for {len(ids)} ids")
        self.ids.extend(ids)
        self.scores.extend(scores.tolist())

    def summarize(self, field: Optional[str] = None):
        arr = np.asarray(self.scores, dtype=np.float64)
        valid = arr[np.isfinite(arr)]
        stats = {
            "average": float(valid.mean()) if valid.size else float("nan"),
            "min_score": float(valid.min()) if valid.size else float("nan"),
            "max_score": float(valid.max()) if valid.size else float("nan"),
            "count": int(arr.size),
        }
        return stats[field] if field else stats

    def write_stats(self, path: str):
        with open(path, "w") as f:
            f.write(f"# {self.name}\n")
            for i, s in zip(self.ids, self.scores):
                f.write(f"{i}\t{s:.6f}\n")
            f.write(f"summary\t{self.summarize('average'):.6f}\n")
