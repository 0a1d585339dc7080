"""The reconstruction's trace (``sfm_tpu_torch/utils/metrics.py``): nested
spans and their totals, the context's stack of open spans, the spans'
ranges on the profiler's clock, and the spans of one small ring through
SfM, BA and MVS on the CPU."""

import threading

import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import ProfilerActivity, profile

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import (
    BaConfig, FeatureConfig, MvsConfig, PipelineConfig, RuntimeConfig,
)
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import metrics, synth
from sfm_tpu_torch.utils.metrics import StageTimer, span

torch.set_num_threads(2)

# Every span the pipeline records, by its key in ``recon.timers.times``.
SPANS = (
    "features", "features.gray", "pair_geometry", "pair_geometry.draw",
    "tracks", "ba", "ba.assemble", "ba.solve", "ba.solve.wait", "ba.fetch",
    "mvs", "mvs.seed", "mvs.expand", "mvs.expand.dispatch",
    "mvs.expand.wait", "mvs.expand.merge", "mvs.filter",
)
# 8 frames of 160x120 give ~19 seeds: round capacity 8 leaves a backlog,
# so the expansion merges it (mvs.expand.merge).
CONFIG = PipelineConfig(
    features=FeatureConfig(max_corners=256, max_matches=128),
    ba=BaConfig(dtype="float64"),
    mvs=MvsConfig(round_capacity=8, max_rounds=3, max_patches=20000,
                  enable_outlier_filter=True),
    runtime=RuntimeConfig(device="cpu"),
)


class Clock:
    """A ``time`` stand-in whose ``perf_counter`` the test advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(metrics, "time", c)
    return c


def test_nested_stages_record_dotted_paths_and_totals(clock):
    tr = StageTimer()
    with tr.stage("a") as path:
        assert path == "a"
        clock.now += 1
        with tr.stage("b") as inner:
            assert inner == "a.b"
            clock.now += 2
            with span("c"):
                clock.now += 4
        with tr.stage("b"):
            clock.now += 8
    with tr.stage("d"):
        clock.now += 16
    assert tr.times == {"a": 15.0, "a.b": 14.0, "a.b.c": 4.0, "d": 16.0}
    # Listed as first opened: a parent before its children.
    assert list(tr.times) == ["a", "a.b", "a.b.c", "d"]


def test_a_stage_nests_only_under_its_own_traces_spans(clock):
    tr, other = StageTimer(), StageTimer()
    with tr.stage("a"):
        with other.stage("x"):
            clock.now += 1
            with tr.stage("y"):  # under tr's "a", not other's "x"
                clock.now += 2
                with span("z"):  # the innermost open span: tr's "a.y"
                    clock.now += 4
            with span("w"):  # the innermost open span: other's "x"
                clock.now += 8
    assert tr.times == {"a": 15.0, "a.y": 6.0, "a.y.z": 4.0}
    assert other.times == {"x": 15.0, "x.w": 8.0}


def test_at_resumes_a_span_whatever_is_open(clock):
    tr = StageTimer()
    with tr.stage("ba"):
        clock.now += 1
    with tr.stage("mvs"):
        with tr.at("ba"), tr.stage("fetch"):
            clock.now += 2
    assert tr.times == {"ba": 3.0, "mvs": 2.0, "ba.fetch": 2.0}


def test_a_span_closes_on_an_exception(clock):
    tr = StageTimer()
    with pytest.raises(ValueError):
        with tr.stage("a"):
            clock.now += 1
            with span("b"):
                clock.now += 2
                raise ValueError("raised inside the span")
    assert tr.times == {"a": 3.0, "a.b": 2.0}
    assert metrics._OPEN.get() == ()
    with tr.stage("c"):  # at the root again
        pass
    assert "c" in tr.times


def test_span_outside_any_stage_records_nothing(clock):
    tr = StageTimer()
    with span("x") as got:
        clock.now += 1
    assert got is None and metrics._OPEN.get() == ()
    with tr.stage("a"):
        pass
    with span("x"):  # "a" is closed
        clock.now += 1
    assert tr.times == {"a": 0.0}


def test_two_threads_keep_separate_stacks(clock):
    tr = StageTimer()
    opened, checked = threading.Event(), threading.Event()
    seen = {}

    def holder():
        with tr.stage("held"):
            opened.set()
            checked.wait(10)

    def other():
        opened.wait(10)
        seen["stack"] = metrics._OPEN.get()
        with span("orphan"):  # "held" is open in the other thread only
            pass
        with tr.stage("own") as path:
            seen["path"] = path
            with span("child"):
                pass
        checked.set()

    threads = [threading.Thread(target=f) for f in (holder, other)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == {"stack": (), "path": "own"}
    assert set(tr.times) == {"held", "own", "own.child"}


def test_summary_total_sums_root_spans_only(clock):
    tr = StageTimer()
    with tr.stage("a"):
        clock.now += 1
        with span("b"):
            clock.now += 2
    with tr.stage("c"):
        clock.now += 4
    lines = tr.summary().splitlines()
    assert lines == ["  a: 3.000s", "    a.b: 2.000s", "  c: 4.000s",
                     "  total: 7.000s"]


def test_view_is_the_live_children_of_a_span(clock):
    tr = StageTimer()
    with tr.stage("ba") as path:
        with tr.stage("solve"):
            with span("wait"):
                clock.now += 1
    view = tr.view(path)
    assert dict(view) == view.times == {"solve": 1.0}
    with tr.at(path), tr.stage("fetch"):
        clock.now += 2
    assert set(view) == {"solve", "fetch"} and view["fetch"] == 2.0
    with pytest.raises(KeyError):
        view["solve.wait"]
    assert tr.view("").times == {"ba": 3.0}


def test_a_span_times_without_the_profiler_range(clock, monkeypatch):
    monkeypatch.setattr(metrics, "_RecordFunctionFast", None)
    tr = StageTimer()
    with tr.stage("a"):
        with span("b"):
            clock.now += 1
    assert tr.times == {"a": 1.0, "a.b": 1.0}


# --- one small ring through SfM, BA and MVS ----------------------------------

@pytest.fixture(scope="module")
def ring():
    images, cal = synth.render_scene(synth.ring_rig(8), w=160, h=120, seed=1,
                                     texture_freq_scale=1.0)
    return images, cal


@pytest.fixture(scope="module")
def traced(ring):
    """The three stages under ``torch.profiler`` on the CPU: the outputs
    and the session's events."""
    images, cal = ring
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recon = structure_from_motion(images, cal, CONFIG)
        recon, info = bundle_adjust(recon, CONFIG.ba, device="cpu")
        dense = dense_reconstruction(images, cal, recon, CONFIG.mvs,
                                     scale=1.0, device="cpu")
    return recon, info, dense, list(prof.events())


def test_ring_records_every_span_each_within_its_parent(traced):
    recon, info, dense, _ = traced
    times = recon.timers.times
    assert set(SPANS) <= set(times), set(SPANS) - set(times)
    for key, seconds in times.items():
        assert seconds > 0, key
        if "." in key:
            assert seconds <= times[key.rsplit(".", 1)[0]], key
    assert (times["mvs.expand.dispatch"] + times["mvs.expand.wait"]
            <= times["mvs.expand"])
    # The stages' readers keep their keys.
    assert set(info["timers"]) == {"assemble", "solve", "fetch"}
    assert set(dense.timers.times) == {"seed", "expand", "filter"}
    assert dense.metrics.values["mvs_backlog_rounds"] > 0
    assert "mvs_backlog_merge_s" not in dense.metrics.values


def test_every_span_is_a_function_scope_cpu_event_within_its_parent(traced):
    recon, _, _, events = traced
    times = recon.timers.times
    spans = [e for e in events if e.name in times]
    assert {e.name for e in spans} == set(times)
    for e in spans:
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name
        # FUNCTION, not record_function's USER_SCOPE, which the profiler
        # mirrors onto the device's timeline.
        assert e.scope == RecordScope.FUNCTION.value, (e.name, e.scope)
        if "." in e.name:
            parent = e.name.rsplit(".", 1)[0]
            assert any(
                p.name == parent
                and p.time_range.start <= e.time_range.start
                and e.time_range.end <= p.time_range.end
                for p in spans), e.name


def test_deferred_fetch_resumes_the_ba_span(ring):
    images, cal = ring
    recon = structure_from_motion(images, cal, CONFIG)
    recon, info = bundle_adjust(recon, CONFIG.ba, device="cpu",
                                defer_fetch=True)
    times = recon.timers.times
    assert "ba.fetch" not in times and set(info["timers"]) == {
        "assemble", "solve"}
    before = times["ba"]
    with recon.timers.stage("mvs"):  # whatever is open when it runs
        info["finalize"]()
    assert set(info["timers"]) == {"assemble", "solve", "fetch"}
    assert "mvs.ba" not in times and "mvs.fetch" not in times
    assert times["ba"] >= before + times["ba.fetch"] > before


def test_a_reconstruction_without_a_trace_gets_one_of_its_own(ring):
    images, cal = ring
    recon = structure_from_motion(images, cal, CONFIG)
    recon.timers = None  # as loaded from a stage file
    recon, info = bundle_adjust(recon, CONFIG.ba, device="cpu")
    dense = dense_reconstruction(images, cal, recon, CONFIG.mvs, scale=1.0,
                                 device="cpu")
    assert recon.timers is None
    assert set(info["timers"]) == {"assemble", "solve", "fetch"}
    assert set(dense.timers.times) == {"seed", "expand", "filter"}
    assert info["timers"].trace is not dense.timers.trace
