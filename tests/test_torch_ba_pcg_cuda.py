"""The PCG camera solve as a CUDA graph (``ba/solver.py:_GraphPCG``), on
the card: a joint ``solve_lm`` on a 363-camera problem of the full dino
set's size (``tools/ba_scale.py``'s drawing: 48,000 points, 108,000
observations) gives the same cameras, points, cost and CG counts bit for
bit by graph replay, by the eager blocked loop and by the per-iteration
loop; every solve there replays the graph; ``bundle_adjust`` by graph
equals the plain reference (``benchmark/sfmref/ba.py``) bit for bit; and a
two-shard mesh on the card stays eager.  Marked ``cuda``; each test skips
where ``torch.cuda.is_available()`` is False.  On the card
(tests/conftest.py imports jax, which the card's machine lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ba_pcg_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sfm_tpu_torch.ba import bundle_adjust, solver
from sfm_tpu_torch.ba.solver import solve_lm
from sfm_tpu_torch.config import BaConfig
from sfm_tpu_torch.parallel.mesh import DataMesh
from sfm_tpu_torch.tools.ba_scale import synth_problem

from test_torch_ba_pcg import (PCG_MAX_CAMS, ba_block, counters,
                               pcg_per_iteration, recon_of, ref_ba,
                               ring_tracks)

pytestmark = pytest.mark.cuda

CAMS, POINTS, OBS = 363, 48_000, 108_000
LM_ITERS = 20


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def problem(device):
    return synth_problem(CAMS, POINTS, OBS, device=device)


def solve_counted(problem, **kw):
    """(solve_lm's result, the counters' increments over it)."""
    before = counters()
    out = solve_lm(problem, max_iterations=LM_ITERS, optimize_cameras=True,
                   **kw)
    torch.cuda.synchronize()
    return out, [b - a for a, b in zip(before, counters())]


def test_graph_eager_and_per_iteration_solves_are_bit_equal(problem,
                                                             monkeypatch):
    graph, graph_counts = solve_counted(problem)
    solves, iters, _, graphed = graph_counts
    assert solves > 0 and iters > 0
    assert graphed == solves
    monkeypatch.setattr(solver, "graphable", lambda mesh: False)
    eager, eager_counts = solve_counted(problem)
    monkeypatch.setattr(solver, "_pcg", pcg_per_iteration)
    loop, loop_counts = solve_counted(problem)
    assert eager_counts == loop_counts == graph_counts[:3] + [0]
    for got in (eager, loop):
        for a, b in zip(graph[:3], got[:3]):
            assert torch.equal(a, b)
        assert graph[3] == got[3]


def test_two_shards_on_the_card_stay_eager(problem, device):
    _, (solves, iters, _, graphed) = solve_counted(
        problem, mesh=DataMesh([device] * 2))
    assert solves > 0 and iters > 0
    assert graphed == 0


def test_bundle_adjust_by_graph_equals_the_reference(device):
    tracks = ring_tracks()
    bc = ba_block(dense_schur_max_cams=PCG_MAX_CAMS, refine_cameras=True)
    before = counters()
    rec, info = bundle_adjust(recon_of(tracks), BaConfig(**bc),
                              device=device)
    solves, iters, _, graphed = (b - a for a, b in zip(before, counters()))
    assert info["camera_solver"] == "pcg"
    assert graphed == solves == info["iterations"] > 0
    assert iters == info["ba_cg_iterations"]
    assert rec.timers.times["ba.solve.cg.wait"] > 0
    K, R, t, world, offsets, obs = tracks
    want = ref_ba.bundle_adjust(K, R, t, world, offsets, obs, bc, device)
    np.testing.assert_array_equal(rec.world, want)
