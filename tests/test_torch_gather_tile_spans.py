"""What the Hopper design of K3 rests on, checked on the CPU.

The kernel (``csrc/gather_tile.cu``) runs only on a GPU
(tests/test_torch_kernels_cuda.py).  Here, on small seeded inputs:

- the shared-memory layouts a window is staged in, emulated.  rows route:
  each window row copied as its 16-byte-aligned span into a slot of its
  sample's tile, at every even base address mod 16; NaN where no byte of
  the stack lands and, poisoned, on the span's bytes outside the row.  tma
  route: the Tensor Memory Accelerator box from the window's column
  rounded down to 8 elements, zero-filled past the stack's width, NaN on
  the box's columns outside the window and on the tile's padding.
  Extracting from the emulated tiles with the consumers' offsets
  (``ops/gather_tile.py:tile_geometry``; per row on the rows route, one
  in-box offset a sample on the tma route) and in the kernel's per-pixel
  order gives ``_sample_plain`` and ``_copy_plain`` bit for bit, on the
  tool's case, on stack edges, on NaN/+-inf/1e10 centres and (rows) on an
  odd-width stack, for wid 0, 2, 5 and 8;
- the route rule (``tile_route``) on aligned, odd-width and offset views;
- the shared-memory plan (``shared_bytes``): the combinations that cannot
  fit a block raise before anything is launched, the tool's sweep fits,
  and its constants are the kernel source's.

No tolerance: every comparison is bit for bit.
"""

import os
import re

import pytest
import torch

from sfm_tpu_torch.ops import gather_tile
from sfm_tpu_torch.ops.gather import _sample_plain
from sfm_tpu_torch.ops.gather_tile import (
    MAX_SHARED_BYTES,
    _copy_plain,
    sample_normalized_patches_tiled,
    shared_bytes,
    tile_geometry,
    tile_route,
)
from sfm_tpu_torch.ops.patches import normalize_descriptors
from sfm_tpu_torch.tools import prof_tile

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAN = float("nan")
WIDS = [0, 2, 5, 8]
BASES = (0, 2, 6, 14)  # the stack's first byte address, mod 16


def window_origin(c, wid, dim):
    """``window_of`` (gather_common.cuh) on one axis: clamped in float before
    the cast; fmax / fmin take the operand that is not NaN."""
    lo = torch.fmax(torch.floor(c) - wid, torch.zeros(()))
    return torch.fmin(lo, torch.full((), float(dim - 2 * wid - 2))).long()


def staged_tiles(gray, img, ctr, wid, base, poison):
    """(M, tile elements) f32: each sample's tile as the producer stages it,
    with the stack's first element at byte address ``base``: row r of the
    window copied as the 16-byte-aligned span around it into slot r.  NaN
    where no byte of the stack lands (past a span, outside the stack) and,
    with ``poison``, on the span's bytes outside the row, which the
    consumers must not read.  Also each window's first element's offset in
    the stack and each row's span size."""
    n, h, w = gray.shape
    g = tile_geometry(wid, "rows")
    win, slot_e = g["win"], g["row"] // 2
    flat = gray.reshape(-1).float()
    total = flat.numel()
    bx, by = window_origin(ctr[:, 0], wid, w), window_origin(ctr[:, 1], wid, h)
    # the window never leaves its image
    assert (bx >= 0).all() and (bx + win <= w).all()
    assert (by >= 0).all() and (by + win <= h).all()
    first = (img.long().clamp(0, n - 1) * h + by) * w + bx
    row0 = first[:, None] + torch.arange(win)[None, :] * w  # (M, win)
    addr = base + 2 * row0
    start = addr & ~15
    span = ((addr + 2 * win + 15) & ~15) - start
    assert (span <= g["row"]).all()
    k = torch.arange(slot_e)
    idx = ((start - base) // 2)[:, :, None] + k
    keep = (k < span[:, :, None] // 2) & (idx >= 0) & (idx < total)
    if poison:
        keep &= (idx >= row0[:, :, None]) & (idx < row0[:, :, None] + win)
    vals = torch.where(keep, flat[idx.clamp(0, total - 1)], torch.full((), NAN))
    tiles = torch.full((img.numel(), g["tile"] // 2), NAN)
    tiles[:, : win * slot_e] = vals.reshape(img.numel(), -1)
    return tiles, first, span


def staged_boxes(gray, img, ctr, wid):
    """(M, tile elements) f32: each sample's tile as a tensor copy stages
    it on the tma route: rows by .. by + win - 1 of its image, columns
    x0 = bx rounded down to 8 .. x0 + box - 1, at a row pitch of ``box``
    elements; 0 past the stack's width (TMA's fill), NaN on the columns
    outside the window, which the consumers must not read, and on the
    tile's padding.  Also each window's column."""
    n, h, w = gray.shape
    g = tile_geometry(wid, "tma")
    win, box = g["win"], g["box"]
    bx, by = window_origin(ctr[:, 0], wid, w), window_origin(ctr[:, 1], wid, h)
    x0 = bx & ~7
    cols = x0[:, None] + torch.arange(box)[None, :]  # (M, box)
    rows = (img.long().clamp(0, n - 1) * h + by)[:, None] + torch.arange(win)
    flat = gray.reshape(-1).float()
    idx = rows[:, :, None] * w + cols.clamp(max=w - 1)[:, None, :]
    vals = torch.where(cols[:, None, :] < w, flat[idx], torch.zeros(()))
    window = (cols >= bx[:, None]) & (cols < bx[:, None] + win)
    vals = torch.where(window[:, None, :], vals, torch.full((), NAN))
    tiles = torch.full((img.numel(), g["tile"] // 2), NAN)
    tiles[:, : win * box] = vals.reshape(img.numel(), -1)
    return tiles, bx


def offsets(wid, w, base, first):
    """(M, side^2) element offsets in its tile of each pixel's top-left
    window element, and of the element below it, as the rows route's
    consumers compute them: byte r * row + 2c plus row r's offset into its
    span, (base + 2 first) mod 16 plus r times the pitch's, 2w mod 16."""
    side = 2 * wid + 1
    row = tile_geometry(wid, "rows")["row"]
    p = torch.arange(side * side)
    r, c = p // side, p % side
    rem0 = (base % 16 + 2 * first[:, None]) & 15

    def at_row(rr):
        return (rr * row + ((rem0 + rr * ((2 * w) & 15)) & 15) + 2 * c) // 2

    return at_row(r), at_row(r + 1)


def box_offsets(wid, bx):
    """The same on the tma route: element r * box + c plus the window's
    offset into its box, bx mod 8, the same on every row."""
    side = 2 * wid + 1
    box = tile_geometry(wid, "tma")["box"]
    p = torch.arange(side * side)
    r, c = p // side, p % side
    at = (bx[:, None] & 7) + c
    return at + r * box, at + (r + 1) * box


def extract(tiles, ctr, top, below):
    """The consumers: the copy-only values, and the full mode's descriptors
    (bilinear in the kernel's per-pixel order, then the plain
    normalisation, bf16)."""
    fx = (ctr[:, 0] - torch.floor(ctr[:, 0]))[:, None]
    fy = (ctr[:, 1] - torch.floor(ctr[:, 1]))[:, None]
    gx, gy = 1 - fx, 1 - fy
    p00, p01 = tiles.gather(1, top), tiles.gather(1, top + 1)
    p10, p11 = tiles.gather(1, below), tiles.gather(1, below + 1)
    val = (p00 * gy) * gx
    val = val + (p01 * gy) * fx
    val = val + (p10 * fy) * gx
    val = val + (p11 * fy) * fx
    return p00.to(torch.bfloat16), normalize_descriptors(val).to(torch.bfloat16)


def input_sets(wid):
    """(name, stack, img, ctr): the tool's case; the edges of the first and
    last image of an aligned and of an odd-width stack, plus NaN, +-inf and
    +-1e10 centres."""
    yield ("tool case", *prof_tile.case_tensors(
        300, torch.device("cpu"), n_img=3, h=40, w=64, wid=wid))
    g = torch.Generator().manual_seed(7 + wid)
    inf = float("inf")
    bad = torch.tensor([[NAN, 20], [20, NAN], [NAN, NAN], [inf, 20],
                        [-inf, 20], [20, inf], [20, -inf], [inf, -inf],
                        [1e10, 20], [20, 1e10], [-1e10, -1e10], [3e9, -3e9]])
    for name, (n, h, w) in (("aligned edges", (3, 40, 64)),
                            ("odd width", (3, 40, 201))):
        gray = (torch.rand((n, h, w), generator=g) * 255).to(torch.bfloat16)
        k = 200
        edge = torch.rand((k, 2), generator=g) * torch.tensor([w - 1.0, 12.0])
        edge[k // 2:, 1] += h - 13.0
        side = torch.rand((k, 2), generator=g) * torch.tensor([12.0, h - 1.0])
        side[k // 2:, 0] += w - 13.0
        ctr = torch.cat([edge, side, bad])
        img = torch.cat([torch.tensor([0, n - 1, 0, n - 1]).repeat_interleave(k // 2),
                         torch.arange(len(bad)) % n]).to(torch.int32)
        yield name, gray, img, ctr


def hold(copy_vals, desc, gray, img, ctr, wid):
    """Copy-only bit-equal to the raw window on every row; the full mode
    bit-equal to the plain version wherever the centre is finite (a
    non-finite centre's fractions are NaN in every version)."""
    fin = torch.isfinite(ctr).all(dim=1)
    assert torch.equal(copy_vals, _copy_plain(gray, img, ctr, wid))
    want = _sample_plain(gray, img, ctr, wid)
    assert torch.isfinite(desc[fin].float()).all()
    assert torch.equal(desc[fin], want[fin])


@pytest.mark.parametrize("wid", WIDS)
def test_rows_route_extraction_is_bit_equal(wid):
    for _, gray, img, ctr in input_sets(wid):
        for base in BASES:
            for poison in (False, True):
                tiles, first, _ = staged_tiles(gray, img, ctr, wid, base, poison)
                top, below = offsets(wid, gray.shape[2], base, first)
                hold(*extract(tiles, ctr, top, below), gray, img, ctr, wid)


@pytest.mark.parametrize("wid", WIDS)
def test_tma_route_extraction_is_bit_equal(wid):
    on_tma = 0
    for name, gray, img, ctr in input_sets(wid):
        if tile_route(gray) != "tma":
            assert name == "odd width"
            continue
        on_tma += 1
        tiles, bx = staged_boxes(gray, img, ctr, wid)
        hold(*extract(tiles, ctr, *box_offsets(wid, bx)), gray, img, ctr, wid)
    assert on_tma == 2


@pytest.mark.parametrize("wid", WIDS)
def test_tma_boxes_start_aligned_and_reach_past_the_width(wid):
    # Every box starts at a multiple of 8 elements (16 bytes: a box that
    # does not faults on the card) and holds its window; on the edges set
    # some boxes run past the width, where TMA fills zeros that are never
    # read.
    g = tile_geometry(wid, "tma")
    _, gray, img, ctr = list(input_sets(wid))[1]
    w = gray.shape[2]
    bx = window_origin(ctr[:, 0], wid, w)
    x0 = bx & ~7
    assert (x0 % 8 == 0).all() and (bx - x0 <= 7).all()
    assert (bx + g["win"] <= x0 + g["box"]).all()
    assert (x0 + g["box"] > w).any()
    assert g["box"] % 8 == 0 and g["box"] <= 256 and g["tile"] % 128 == 0


def test_tile_route():
    assert tile_route(torch.zeros((3, 40, 64), dtype=torch.bfloat16)) == "tma"
    assert tile_route(torch.zeros((3, 40, 640), dtype=torch.bfloat16)) == "tma"
    assert tile_route(torch.zeros((3, 40, 201), dtype=torch.bfloat16)) == "rows"
    assert tile_route(torch.zeros((3, 40, 36), dtype=torch.bfloat16)) == "rows"
    # by pitch and alignment: a view whose first element is not 16-byte
    # aligned cannot be a tensor map's base
    flat = torch.zeros(3 * 40 * 64 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    for off, route in ((1, "rows"), (2, "rows"), (4, "rows"), (8, "tma")):
        view = flat[off:off + 3 * 40 * 64].view(3, 40, 64)
        assert view.is_contiguous() and tile_route(view) == route
    assert tile_route(torch.zeros((3, 40, 64), dtype=torch.bfloat16)[1:]) == "tma"


def test_shared_plan_admits_the_tool_sweep():
    for route in ("tma", "rows"):
        for _, _, S, kw in prof_tile.modes():
            assert shared_bytes(5, S, kw["double_buffer"], route) <= MAX_SHARED_BYTES
    # wid 5: rows, 12 slots of 48 bytes a window; tma, 12 box rows of 24
    # elements (48 bytes) in a 640-byte tile.  S 128 double-buffered: the
    # tiles, 4,096 bytes of records, barriers and alignment slack
    assert tile_geometry(5, "rows") == {"win": 12, "row": 48, "tile": 576}
    assert tile_geometry(5, "tma") == {"win": 12, "box": 24, "row": 48,
                                       "tile": 640}
    assert shared_bytes(5, 128, True, "rows") == 128 + 128 + 4096 + 147456
    assert shared_bytes(5, 128, True, "tma") == 128 + 128 + 4096 + 163840
    for wid in range(9):
        g = tile_geometry(wid, "rows")
        assert g["row"] % 16 == 0 and g["row"] >= 2 * g["win"] + 14
        assert g["tile"] == g["row"] * g["win"]
        t = tile_geometry(wid, "tma")
        assert t["box"] % 8 == 0 and t["box"] >= t["win"] + 7
        assert t["tile"] % 128 == 0 and t["tile"] >= t["row"] * t["win"]


@pytest.mark.parametrize("route", ["tma", "rows"])
@pytest.mark.parametrize("wid,S,double", [
    (8, 256, True), (8, 256, False), (5, 256, True), (7, 256, True),
    (8, 128, True)])
def test_shared_plan_refuses_what_cannot_fit(wid, S, double, route):
    assert shared_bytes(wid, S, double, route) > MAX_SHARED_BYTES
    gray = torch.zeros((2, 40, 64 if route == "tma" else 60), dtype=torch.bfloat16)
    assert tile_route(gray) == route
    img = torch.zeros(4, dtype=torch.int32)
    ctr = torch.full((4, 2), 20.0)
    before = sample_normalized_patches_tiled.launches
    with pytest.raises(ValueError, match="shared memory"):
        sample_normalized_patches_tiled(gray, img, ctr, wid, samples_per_block=S,
                                        double_buffer=double)
    assert sample_normalized_patches_tiled.launches == before
    # the largest S that fits runs (here, the plain version)
    fits = max(s for s in range(1, 257)
               if shared_bytes(wid, s, double, route) <= MAX_SHARED_BYTES)
    out = sample_normalized_patches_tiled(gray, img, ctr, wid,
                                          samples_per_block=fits,
                                          double_buffer=double)
    assert out.shape == (4, (2 * wid + 1) ** 2)


def test_plan_constants_are_the_kernels():
    with open(os.path.join(REPO, "sfm_tpu_torch", "csrc", "gather_tile.cu")) as f:
        text = f.read()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert consts["kTileAlign"] == gather_tile.TILE_ALIGN
    assert consts["kParamBytes"] == gather_tile.PARAM_BYTES
    assert consts["kBarrierBytes"] == gather_tile.BARRIER_BYTES
    assert consts["kMaxSharedBytes"] == gather_tile.MAX_SHARED_BYTES
    assert consts["kMaxSamplesPerBlock"] == gather_tile.MAX_SAMPLES_PER_BLOCK
