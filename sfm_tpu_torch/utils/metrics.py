"""Structured metrics and the reconstruction's trace.

The reference's observability is ~40 bare ``print()`` sites (SURVEY.md §5);
here the same signals (inlier counts, reprojection-error stats, BA problem
size and wall time, seed counts, expansion progress) are collected into a
structured object that can be printed, logged, or serialized.

``StageTimer`` is the trace of one reconstruction: ``structure_from_motion``
makes it and leaves it on ``SparseReconstruction.timers``, and
``bundle_adjust`` and ``dense_reconstruction`` add their spans to it.
Spans nest: one opened while another span of the same trace is open
records under the dotted path (``mvs.expand.dispatch``), and ``times``
maps each path to its total seconds.  ``span(name)`` opens a child of the
innermost open span of the current context (thread or task), so code
below a stage adds spans without being handed the trace; outside any open
span it records nothing.

Every span is also a range of the same name on the profiler's clock, of
FUNCTION scope (``_RecordFunctionFast``): a CPU event of a
``torch.profiler`` session, which the profiler does not mirror onto the
device timeline as it does ``record_function``'s USER_SCOPE ranges.  With
no profiler active the range costs one C++ guard.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # a torch without it: spans time, open no range
    _RecordFunctionFast = None


@dataclass
class Metrics:
    values: Dict[str, Any] = field(default_factory=dict)

    def record(self, key: str, value) -> None:
        self.values[key] = value

    def to_json(self) -> str:
        def clean(v):
            try:
                json.dumps(v)
                return v
            except TypeError:
                return float(v) if hasattr(v, "__float__") else str(v)

        return json.dumps({k: clean(v) for k, v in self.values.items()})


# The open spans of the current context, innermost last: (trace, path).
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "sfm_tpu_torch_open_spans", default=())
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One span of ``trace`` at ``path``; entering it gives the path."""

    __slots__ = ("trace", "path", "_range", "_token", "_t0")

    def __init__(self, trace: "StageTimer", path: str):
        self.trace = trace
        self.path = path

    def __enter__(self) -> str:
        self._token = _OPEN.set(_OPEN.get() + ((self.trace, self.path),))
        # Listed when first opened, so a parent precedes its children.
        self.trace.times.setdefault(self.path, 0.0)
        self._range = None
        if _RecordFunctionFast is not None:
            self._range = _RecordFunctionFast(self.path)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self.path

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self.trace.times[self.path] += dt
        _OPEN.reset(self._token)
        return False


def span(name: str):
    """A span ``name`` under the innermost open span of the current
    context, in that span's trace; records nothing where none is open."""
    open_spans = _OPEN.get()
    if not open_spans:
        return _NO_SPAN
    trace, path = open_spans[-1]
    return _Span(trace, f"{path}.{name}")


class StageTimer:
    """The trace of one reconstruction: dotted span path -> total wall
    seconds (the stage timing of the reference's BA/MVS time prints at
    SFM.py:175-179, MVS2.py:287-289)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    def stage(self, name: str) -> _Span:
        """A span ``name`` under this trace's innermost open span of the
        current context, or at its root where none is open."""
        for trace, path in reversed(_OPEN.get()):
            if trace is self:
                return _Span(self, f"{path}.{name}")
        return _Span(self, name)

    def at(self, path: str) -> _Span:
        """A span at ``path`` whatever is open: a step that runs after its
        stage has returned resumes the stage's span."""
        return _Span(self, path)

    def view(self, path: str) -> "StageView":
        return StageView(self, path)

    def summary(self) -> str:
        """One line a span, indented by depth; the total sums the root
        spans, which hold their children's time."""
        total = sum(v for k, v in self.times.items() if "." not in k)
        lines = [f"  {'  ' * k.count('.')}{k}: {v:.3f}s"
                 for k, v in self.times.items()]
        lines.append(f"  total: {total:.3f}s")
        return "\n".join(lines)


class StageView(Mapping):
    """The direct children of the span at ``path`` in ``trace``, keyed by
    their own names: what a stage hands its readers (``bundle_adjust``'s
    ``info["timers"]``, ``DenseReconstruction.timers``).  Live: a child
    recorded later (a deferred ``finalize``) shows."""

    def __init__(self, trace: StageTimer, path: str):
        self.trace = trace
        self.path = path
        self._prefix = f"{path}." if path else ""

    def __getitem__(self, name: str) -> float:
        if "." in name:
            raise KeyError(name)
        return self.trace.times[self._prefix + name]

    def __iter__(self):
        n = len(self._prefix)
        return iter([k[n:] for k in self.trace.times
                     if k.startswith(self._prefix) and "." not in k[n:]])

    def __len__(self) -> int:
        return sum(1 for _ in self)

    @property
    def times(self) -> Dict[str, float]:
        """The children's totals as they stand, as a plain dict."""
        return dict(self)
