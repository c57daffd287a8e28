"""CSV manifest utilities.

The port's copy of ``audiocodecs_tpu/downstream/datasets/manifest.py``.

Same manifest contract as the reference's dataset preps (reference
``downstream/datasets/*.py``): CSV rows with ``ID, duration, wav`` plus
task-specific columns, ``$DATA_ROOT`` placeholder substitution, duration
filtering/sorting, and multi-CSV merging (reference ``utils.py:86-117``).
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

__all__ = ["read_manifest", "write_manifest", "merge_manifests",
           "filter_by_duration", "sort_by_duration", "DATA_ROOT_VAR"]

DATA_ROOT_VAR = "$DATA_ROOT"


def read_manifest(path: str, data_root: Optional[str] = None) -> list[dict]:
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if data_root is not None:
                row = {
                    k: (v.replace(DATA_ROOT_VAR, data_root)
                        if isinstance(v, str) else v)
                    for k, v in row.items()
                }
            if "duration" in row:
                row["duration"] = float(row["duration"])
            rows.append(row)
    return rows


def write_manifest(path: str, rows: Sequence[dict]) -> None:
    if not rows:
        raise ValueError("empty manifest")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def merge_manifests(paths: Sequence[str], out_path: str) -> None:
    rows = []
    for p in paths:
        rows.extend(read_manifest(p))
    write_manifest(out_path, rows)


def filter_by_duration(rows, min_s: float = 0.0,
                       max_s: float = float("inf")) -> list[dict]:
    return [r for r in rows if min_s <= r["duration"] <= max_s]


def sort_by_duration(rows, reverse: bool = False) -> list[dict]:
    return sorted(rows, key=lambda r: r["duration"], reverse=reverse)
