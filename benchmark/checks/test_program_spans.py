"""The readers of the program's spans (``metrics/<name>.py`` with source
``program_span``) on a hand-made ``RunData``: each gives the mean over the
window's passes of one key of a pass's ``timers``, and nothing where no
pass has it (the parent of the change that added the span)."""

import pytest

from conftest import REPO

# metric -> the key of ``recon.timers.times`` it reads, and the cells that
# report it (None: every cell).
SPANS = {
    "sfm_gray_s": ("features.gray", None),
    "sfm_ransac_draw_s": ("pair_geometry.draw", None),
    "ba_lm_wait_s": ("ba.solve.wait", None),
    "mvs_enqueue_s": ("mvs.expand.dispatch", (
        "dino_ring48.seq_scale10", "temple_sparse16.seq_scale1",
        "dino_ring48.allpairs_joint")),
    "mvs_payload_wait_s": ("mvs.expand.wait", (
        "dino_ring48.seq_scale10", "temple_sparse16.seq_scale1",
        "dino_ring48.allpairs_joint")),
}


def _reader(name):
    from benchkit.catalog import Catalog

    cat = Catalog(REPO)
    (entry,) = [m for m in cat.spec["per_layer"] if m["name"] == name]
    return entry, cat.reader(entry)


def _run(timers):
    from benchkit.harness import RunData

    run = RunData(frames=48, shapes={})
    run.passes = [{"wall": 0.5, "timers": t} for t in timers]
    return run


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_gives_the_mean_of_its_span(name):
    key, cells = SPANS[name]
    entry, reader = _reader(name)
    assert (entry["source"], entry["unit"], entry["better"],
            entry["moves"]) == ("program_span", "s", "lower", "frames_per_s")
    assert tuple(entry.get("workloads", ())) == (cells or ())
    run = _run([{"features": 0.3, key: 0.25}, {key: 0.125},
                {"features": 0.3}, {key: 0.0}])
    assert reader.read(run) == pytest.approx(0.125)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_gives_nothing_without_its_span(name):
    key, _ = SPANS[name]
    _, reader = _reader(name)
    parent = key.rsplit(".", 1)[0]
    assert reader.read(_run([{"features": 0.3, "pair_geometry": 0.04},
                             {parent: 0.2}])) is None
    assert reader.read(_run([])) is None
