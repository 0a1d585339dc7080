"""Tile-resident descriptor sampler: K2's function from staged windows.

Counterpart of ``tools/prof_tile.py:make_gather_kernel``, the Pallas kernel
of the tile-resident gather experiments that sized K2 on the TPU.
``sample_normalized_patches_tiled`` is the wrapper of kernel K3
(``csrc/gather_tile.cu``): per step producer warps have the copy engine
bring ``samples_per_block`` samples' windows into a ring of shared-memory
stages -- one Tensor Memory Accelerator box a window where the stack
allows a tensor map, else each window row's 16-byte-aligned span
(``tile_route`` says which of its two kernels a stack takes) -- and
consumer warps extract and normalise from there; with ``double_buffer``
the ring has two stages, so the next step's copies are in flight while a
step is processed; with ``extract=False`` it only copies the staged
window's first side x side values out (the cost of the copies alone).
``shared_bytes`` is the kernel's shared-memory plan, which the wrapper
checks before a launch.

The TPU tool's ``gather_params`` (8-row ``row8``/``dy``, 128-lane
``x_al``/``x_rem``, operands packed to SMEM 1024-blocks) has no counterpart:
the kernel derives each window's origin and fractions from (image, cx, cy).
Its extraction variants ``extract`` = 2, 3, 4 computed the same values as
``extract=True`` and differed only in how Mosaic was made to shift rows and
lanes (row select first, a sublane roll, one batched cast); shared memory is
indexed directly, so they collapse to the one extraction here.

The plain versions are in this module too: ``_sample_plain`` of
``ops/gather.py`` for the full modes (K3 shares K2's arithmetic, so also
K2's plain version) and ``_copy_plain`` for the copy-only mode.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops._launch import check_launch, launch_on, on_cpu
from sfm_tpu_torch.ops.gather import MAX_WID, _sample_plain
from sfm_tpu_torch.utils.build import kernel_library

MAX_SAMPLES_PER_BLOCK = 256

# The kernel's shared-memory plan (csrc/gather_tile.cu: the constants of the
# same names and ``shared_bytes``).
TILE_ALIGN = 128          # bytes: the records and the tiles start aligned
PARAM_BYTES = 16          # one sample's record (fractions, window origin)
BARRIER_BYTES = 128       # the ring's mbarriers, padded
MAX_SHARED_BYTES = 232448  # a block's 227 KB on Hopper


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def tile_route(gray) -> str:
    """The staging route K3 takes for the (N, H, W) bf16 stack ``gray``, by
    the rule its C entry point applies: "tma" where a tensor map can
    describe the stack -- its first element 16-byte aligned and a row a
    multiple of 16 bytes (W % 8 == 0) -- one box a window (kernel
    ``gather_tile_tma_kernel``); else "rows", each window row's
    16-byte-aligned span (``gather_tile_rows_kernel``)."""
    aligned = gray.shape[-1] % 8 == 0 and gray.data_ptr() % 16 == 0
    return "tma" if aligned else "rows"


def tile_geometry(wid: int, route: str) -> dict:
    """One staged window as the kernel lays it out on ``route``, for
    half-width ``wid``: ``win`` (window side), ``row`` (bytes a tile row
    holds) and ``tile`` (bytes from one sample's tile to the next).  tma: a
    box row of ``box`` elements, the window's row from its column rounded
    down to 8 elements, tiles 128-byte aligned as a tensor copy's
    destination.  rows: the widest 16-byte-aligned span of a window row,
    which starts at any even byte."""
    win = 2 * wid + 2
    if route == "tma":
        box = _round_up(win + 7, 8)
        return {"win": win, "box": box, "row": 2 * box,
                "tile": _round_up(2 * box * win, TILE_ALIGN)}
    row = _round_up(2 * win + 14, 16)
    return {"win": win, "row": row, "tile": row * win}


def shared_bytes(wid: int, samples_per_block: int, double_buffer: bool,
                 route: str) -> int:
    """Dynamic shared memory of one K3 block on ``route``: alignment slack,
    the ring's barriers, every stage's sample records and every stage's
    tiles."""
    stages = 2 if double_buffer else 1
    records = _round_up(stages * samples_per_block * PARAM_BYTES, TILE_ALIGN)
    return (TILE_ALIGN + BARRIER_BYTES + records
            + stages * samples_per_block * tile_geometry(wid, route)["tile"])


def _copy_plain(gray, img, ctr, wid):
    """Plain version of the copy-only mode on flat (M,) img / (M, 2) ctr:
    the first side x side values of each sample's window, (M, side^2) bf16.
    The window origin is clamped in float (NaN reads at 0), as the kernels
    take it."""
    n, h, w = gray.shape
    side = 2 * wid + 1
    img = img.long().clamp(0, n - 1)

    def origin(c, dim):
        o = torch.nan_to_num(torch.floor(c) - wid, nan=0.0)
        return o.clamp(0, dim - side - 1).long()

    bx = origin(ctr[:, 0], w)
    by = origin(ctr[:, 1], h) + img * h
    off = torch.arange(side, device=gray.device)
    window = gray.reshape(n * h, w)[
        (by[:, None] + off)[:, :, None], (bx[:, None] + off)[:, None, :]
    ]
    return window.reshape(-1, side * side)


def sample_normalized_patches_tiled(
    gray, img_idx, centers, wid: int = 5, *, samples_per_block: int = 32,
    double_buffer: bool = True, extract: bool = True,
):
    """K2's descriptors through shared-memory tiles (kernel K3).

    Args:
      gray: (N, H, W) bfloat16 grayscale stack.
      img_idx: (M,) int32 image index per sample.
      centers: (M, 2) float32 (x, y) patch centers.
      wid: half-width (<= 8); patch side = 2*wid+1.
      samples_per_block: S, the windows a block stages per step (1..256).
      double_buffer: two stages, so step i+1's copies start before step i
        is processed; one stage otherwise.
      extract: True interpolates and normalises (``sample_normalized_patches``'s
        descriptors); False copies each window's first side x side values
        out unchanged.

    Returns (M, side^2) bf16.  CUDA tensors go through kernel K3 (counted in
    ``sample_normalized_patches_tiled.launches``) on the route
    ``tile_route(gray)``; CPU tensors through the plain version.  An S and
    ``wid`` whose stages cannot fit a block's shared memory on that route
    (``shared_bytes`` over ``MAX_SHARED_BYTES``) raise ValueError on any
    device, before anything is launched.
    """
    if gray.dim() != 3 or gray.dtype != torch.bfloat16:
        raise TypeError(
            f"gray must be (N, H, W) bfloat16, got {tuple(gray.shape)} "
            f"{gray.dtype}"
        )
    if img_idx.dtype != torch.int32 or centers.dtype != torch.float32:
        raise TypeError(
            f"img_idx must be int32 and centers float32, got "
            f"{img_idx.dtype} / {centers.dtype}"
        )
    if img_idx.dim() != 1 or centers.shape != (img_idx.shape[0], 2):
        raise ValueError(
            f"img_idx must be (M,) and centers (M, 2), got "
            f"{tuple(img_idx.shape)} / {tuple(centers.shape)}"
        )
    n, h, w = gray.shape
    side = 2 * wid + 1
    if not 0 <= wid <= MAX_WID or h < side + 1 or w < side + 1:
        raise ValueError(f"wid={wid} unsupported for {h}x{w} images")
    if not 1 <= samples_per_block <= MAX_SAMPLES_PER_BLOCK:
        raise ValueError(
            f"samples_per_block={samples_per_block} outside "
            f"1..{MAX_SAMPLES_PER_BLOCK}"
        )
    route = tile_route(gray)
    need = shared_bytes(wid, samples_per_block, double_buffer, route)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"samples_per_block={samples_per_block} "
            f"{'double' if double_buffer else 'single'}-buffered at wid={wid} "
            f"on the {route} route "
            f"needs {need} bytes of shared memory, more than a block's "
            f"{MAX_SHARED_BYTES}"
        )
    m = img_idx.shape[0]
    if on_cpu("sample_normalized_patches_tiled", gray, img_idx, centers):
        plain = _sample_plain if extract else _copy_plain
        return plain(gray, img_idx, centers, wid)
    out = torch.empty((m, side * side), dtype=torch.bfloat16,
                      device=gray.device)
    if m:
        with launch_on(gray) as stream:
            err = kernel_library().sample_normalized_patches_tiled_bf16(
                gray.data_ptr(), img_idx.data_ptr(), centers.data_ptr(),
                out.data_ptr(), m, n, h, w, wid, samples_per_block,
                int(bool(double_buffer)), int(bool(extract)), stream,
            )
        check_launch("sample_normalized_patches_tiled", err)
        sample_normalized_patches_tiled.launches += 1
    return out


sample_normalized_patches_tiled.launches = 0
