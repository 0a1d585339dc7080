"""Joint bundle adjustment by PCG (``ba/solver.py:_pcg``): the port's
``bundle_adjust(refine_cameras=True)`` against the benchmark's plain
reference (``benchmark/sfmref/ba.py``) on seeded tracks, the dense gate at
the full dino set's 363 cameras, the PCG solve's spans and counters, and
the blocked loop with its stop rule on the device against a loop that
tests the residual on the host before every iteration."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.ba.run import dense_gate_counts
from sfm_tpu_torch.ba import solver
from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.ba.solver import CG_BLOCK, solve_lm
from sfm_tpu_torch.config import BaConfig
from sfm_tpu_torch.io.calib import Calibration
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils import synth
from sfm_tpu_torch.utils.metrics import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from sfmref import ba as ref_ba  # noqa: E402

torch.set_num_threads(2)

N_CAMS, W, H, F = 12, 200, 150, 240.0
# Below the ring's 12 cameras, so that both sides solve the reduced camera
# system by PCG ("max_cams").
PCG_MAX_CAMS = 8
CG_SPANS = ("ba.solve.cg", "ba.solve.cg.wait")
# LM iterations of the PCG solves here, to keep them to seconds on the CPU.
LM_ITERS = 12


def ring_tracks(n_points=300, seed=0):
    """(K, R, t, world, offsets, obs): points on the unit sphere seen by
    the cameras of a 12-camera ring that face them, observed at their
    projections plus seeded pixel noise rounded to whole pixels (the
    track store's integer corners), their world points off by seeded
    noise."""
    rng = np.random.default_rng(seed)
    centers = synth.ring_rig(N_CAMS)
    Rs, ts = zip(*(synth.look_at(c, np.zeros(3)) for c in centers))
    R, t = np.stack(Rs), np.stack(ts)
    K = np.tile(np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]]),
                (N_CAMS, 1, 1))
    world, offsets, obs = [], [0], []
    while len(world) < n_points:
        p = rng.normal(size=3)
        p /= np.linalg.norm(p)
        rows = []
        for i in range(N_CAMS):
            if np.dot(p, centers[i] - p) <= 0.2:
                continue
            pc = R[i] @ p + t[i]
            u = K[i] @ (pc / pc[2])
            xy = np.rint(u[:2] + rng.normal(scale=0.7, size=2))
            if 2 <= xy[0] < W - 2 and 2 <= xy[1] < H - 2:
                rows.append((i, xy[0], xy[1]))
        if len(rows) >= 2:
            world.append(p + rng.normal(scale=0.01, size=3))
            obs.extend(rows)
            offsets.append(len(obs))
    return (K, R, t, np.array(world), np.array(offsets, np.int64),
            np.array(obs, np.int32))


@pytest.fixture(scope="module")
def tracks():
    return ring_tracks()


def recon_of(tracks):
    K, R, t, world, offsets, obs = tracks
    calib = Calibration(K=K, R=R, t=t,
                        names=tuple(f"c{i:02d}" for i in range(N_CAMS)))
    return SparseReconstruction(calib=calib, world=world.copy(),
                                track_offsets=offsets, track_obs=obs,
                                timers=StageTimer())


def ba_block(**over):
    """The ``ba`` block of the benchmark's configurations, with ``over``."""
    with open(os.path.join(BENCH, "configs", "dino_full363.json")) as f:
        block = json.load(f)["pipeline"]["ba"]
    return dict(block, **over)


def counters():
    return (solve_lm.cg_solves, solve_lm.cg_iterations, solve_lm.cg_capped,
            solve_lm.cg_graph_solves)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_joint_pcg_matches_the_reference(tracks, dtype):
    bc = ba_block(dtype=dtype, dense_schur_max_cams=PCG_MAX_CAMS,
                  max_iterations=LM_ITERS, refine_cameras=True)
    rec, info = bundle_adjust(recon_of(tracks), BaConfig(**bc), device="cpu")
    K, R, t, world, offsets, obs = tracks
    want = ref_ba.bundle_adjust(K, R, t, world, offsets, obs, bc,
                                torch.device("cpu"))
    assert info["camera_solver"] == "pcg"
    assert info["ba_dense_schur_decided_by"] == "max_cams"
    assert info["ba_cg_iterations"] > 0
    assert np.abs(rec.world - world).max() > 1e-3  # the solve moved them
    np.testing.assert_allclose(rec.world, want, rtol=0, atol=1e-5)


def test_dense_gate_sends_the_full_dino_set_to_pcg():
    gate = dense_gate_counts(np.full(50_000, 3), 363,
                             BaConfig(**ba_block(refine_cameras=True)))
    assert gate["ba_dense_schur_decided_by"] == "max_cams"
    # The 48-view ring's joint solve stays dense under the same block.
    gate = dense_gate_counts(np.full(7_000, 3), 48,
                             BaConfig(**ba_block(refine_cameras=True)))
    assert gate["ba_dense_schur_decided_by"] == "dense"


def test_pcg_solve_records_its_spans_and_counts(tracks):
    before = counters()
    rec, info = bundle_adjust(
        recon_of(tracks),
        BaConfig(**ba_block(dense_schur_max_cams=PCG_MAX_CAMS,
                            max_iterations=LM_ITERS, refine_cameras=True)),
        device="cpu")
    solves, iters, capped, graphed = (b - a
                                      for a, b in zip(before, counters()))
    times = rec.timers.times
    for key in CG_SPANS:
        assert key in times, key
    assert 0 < times["ba.solve.cg.wait"] <= times["ba.solve.cg"] \
        <= times["ba.solve"]
    # One PCG solve a LM iteration; the info's counts are the counters'.
    assert solves == info["iterations"]
    assert iters == info["ba_cg_iterations"] >= solves
    assert capped == info["ba_cg_capped"] <= solves
    assert rec.metrics.values["ba_cg_iterations"] == iters
    assert rec.metrics.values["ba_cg_capped"] == capped
    # The CPU solves eagerly: no graph.
    assert graphed == 0


@pytest.mark.parametrize("refine", [True, False], ids=["dense", "points"])
def test_dense_and_points_only_solves_leave_pcg_untouched(tracks, refine):
    before = counters()
    rec, info = bundle_adjust(recon_of(tracks),
                              BaConfig(**ba_block(refine_cameras=refine)),
                              device="cpu")
    assert counters() == before
    assert info["camera_solver"] == ("dense_schur" if refine else "frozen")
    for key in CG_SPANS:
        assert key not in rec.timers.times, key
    assert "ba.solve.wait" in rec.timers.times
    if refine:
        assert info["ba_cg_iterations"] == info["ba_cg_capped"] == 0
    else:
        assert "ba_cg_iterations" not in info


# --- The blocked loop against the per-iteration loop -----------------------

def pcg_per_iteration(matvec, b, Minv_blocks, iters, tol):
    """The PCG loop with the residual tested on the host before every
    iteration, as the JAX package's loop and the plain reference run it:
    (x, iterations run)."""

    def apply_prec(r):
        return torch.einsum("nij,nj->ni", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
    it = 0
    while it < iters:
        if not bool(torch.sqrt(torch.sum(r * r)) > tol * bnorm):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def spd_system(dtype, n=16, seed=0):
    """(matvec, b, block-Jacobi preconditioner) of a seeded symmetric
    positive definite (n, 12) system with eigenvalues from 1 to 1e3."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(12 * n, 12 * n)))
    A = torch.tensor((q * np.geomspace(1, 1e3, 12 * n)) @ q.T, dtype=dtype)
    b = torch.tensor(rng.normal(size=(n, 12)), dtype=dtype)
    diag = torch.stack([A[12 * i:12 * i + 12, 12 * i:12 * i + 12]
                        for i in range(n)])
    return ((lambda x: (A @ x.reshape(-1)).reshape(n, 12)), b,
            torch.linalg.inv(diag))


# case -> (iters, tol, zero right-hand side, what the per-iteration loop
# runs: "mid" stops by tol inside a block, else that count).
PCG_CASES = {
    "tol_mid_block": (100, 0.03, False, "mid"),
    "zero_b": (100, 1e-6, True, 0),
    "cap_23": (23, 1e-30, False, 23),
    "capped": (40, 1e-30, False, 40),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(PCG_CASES))
def test_blocked_pcg_equals_the_per_iteration_loop(case, dtype):
    iters, tol, zero_b, runs = PCG_CASES[case]
    matvec, b, Minv = spd_system(getattr(torch, dtype))
    if zero_b:
        b = torch.zeros_like(b)
    x_want, n_want = pcg_per_iteration(matvec, b, Minv, iters, tol)
    if runs == "mid":
        assert 0 < n_want < iters and n_want % CG_BLOCK, n_want
    else:
        assert n_want == runs
    x, n = solver._pcg(matvec, b, Minv, iters, tol)
    assert n == n_want
    assert torch.equal(x, x_want)


def test_solve_lm_equals_it_with_the_per_iteration_loop(tracks, monkeypatch):
    """A joint ``solve_lm`` by PCG gives the same bits whether its camera
    solves run the blocked loop or the per-iteration one."""
    rec = recon_of(tracks)
    problem = build_problem(rec.calib, rec.world, rec.track_offsets,
                            rec.track_obs)
    kw = dict(max_iterations=LM_ITERS, optimize_cameras=True)
    before = counters()
    blocked = solve_lm(problem, **kw)
    its = solve_lm.cg_iterations - before[1]
    monkeypatch.setattr(solver, "_pcg", pcg_per_iteration)
    per_iteration = solve_lm(problem, **kw)
    assert solve_lm.cg_iterations - before[1] == 2 * its > 0
    for got, want in zip(blocked[:3], per_iteration[:3]):
        assert torch.equal(got, want)
    assert blocked[3] == per_iteration[3]


# --- The benchmark's readers of the spans and counters ----------------------

def _reader(name):
    from benchkit.catalog import Catalog

    cat = Catalog(REPO)
    (entry,) = [m for m in cat.spec["per_layer"] if m["name"] == name]
    return entry, cat.reader(entry)


def _run(timers):
    from benchkit.harness import RunData

    run = RunData(frames=363, shapes={})
    run.passes = [{"wall": 2.0, "timers": t} for t in timers]
    return run


@pytest.mark.parametrize("name,key", [("ba_cg_s", "ba.solve.cg"),
                                      ("ba_cg_wait_s", "ba.solve.cg.wait")])
def test_span_readers_give_the_mean_of_their_span(name, key):
    entry, reader = _reader(name)
    assert (entry["source"], entry["unit"], entry["moves"],
            entry["workloads"]) == ("program_span", "s", "frames_per_s",
                                    ["dino_full363.seq_joint_scale10"])
    assert reader.read(_run([{"ba.solve": 1.0, key: 0.5}, {key: 0.25},
                             {"ba.solve": 0.1}, {key: 0.0}])) \
        == pytest.approx(0.25)
    # A pass without the span (the parent, a dense or points-only solve).
    assert reader.read(_run([{"ba.solve": 0.2, "ba.solve.wait": 0.1}])) is None
    assert reader.read(_run([])) is None


def test_iterations_reader_divides_the_process_counters(monkeypatch):
    entry, reader = _reader("ba_cg_iters_per_solve")
    assert (entry["source"], entry["moves"]) == ("program_counter",
                                                 "frames_per_s")
    monkeypatch.setattr(solve_lm, "cg_solves", 8)
    monkeypatch.setattr(solve_lm, "cg_iterations", 620)
    assert reader.read(_run([])) == pytest.approx(77.5)
    monkeypatch.setattr(solve_lm, "cg_solves", 0)
    assert reader.read(_run([])) is None
    # A program without the counters (the parent) gives nothing.
    monkeypatch.delattr(solve_lm, "cg_solves")
    assert reader.read(_run([])) is None


def test_graph_share_reader_divides_the_process_counters(monkeypatch):
    entry, reader = _reader("ba_cg_graph_share")
    assert (entry["source"], entry["unit"], entry["better"], entry["moves"],
            entry["workloads"]) == ("program_counter", "share", "higher",
                                    "frames_per_s",
                                    ["dino_full363.seq_joint_scale10"])
    monkeypatch.setattr(solve_lm, "cg_solves", 8)
    monkeypatch.setattr(solve_lm, "cg_graph_solves", 6)
    assert reader.read(_run([])) == pytest.approx(0.75)
    monkeypatch.setattr(solve_lm, "cg_solves", 0)
    assert reader.read(_run([])) is None
    # A program without the graph counter (the parent) gives nothing.
    monkeypatch.setattr(solve_lm, "cg_solves", 8)
    monkeypatch.delattr(solve_lm, "cg_graph_solves")
    assert reader.read(_run([])) is None
