"""Structured metrics + stage timing.

The reference's observability is ~40 bare ``print()`` sites (SURVEY.md §5);
here the same signals (inlier counts, reprojection-error stats, BA problem
size and wall time, seed counts, expansion progress) are collected into a
structured object that can be printed, logged, or serialized.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class Metrics:
    values: Dict[str, Any] = field(default_factory=dict)

    def record(self, key: str, value) -> None:
        self.values[key] = value

    def increment(self, key: str, amount=1) -> None:
        self.values[key] = self.values.get(key, 0) + amount

    def to_json(self) -> str:
        def clean(v):
            try:
                json.dumps(v)
                return v
            except TypeError:
                return float(v) if hasattr(v, "__float__") else str(v)

        return json.dumps({k: clean(v) for k, v in self.values.items()})

    def summary(self) -> str:
        lines = [f"  {k}: {v}" for k, v in sorted(self.values.items())]
        return "\n".join(lines)


class StageTimer:
    """Wall-clock timing per pipeline stage (the analogue of the reference's
    BA/MVS time prints at SFM.py:175-179, MVS2.py:287-289)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"  {k}: {v:.3f}s" for k, v in self.times.items()]
        lines.append(f"  total: {total:.3f}s")
        return "\n".join(lines)
