"""Per-image cell occupancy grids.

Counterpart of ``sfm_tpu/mvs/cells.py``: occupancy is one (N, Cx, Cy) bool
tensor updated by scatter.  Convention: True = occupied.  Cell mapping:
cell = floor(pixel / cell_size), grid (ceil((W-1)/s), ceil((H-1)/s)) per
image, indexed [cell_x, cell_y].
"""

from __future__ import annotations

import math

import torch


def grid_shape(h: int, w: int, cell_size: int):
    """(Cx, Cy) grid dimensions."""
    return (
        math.ceil((w - 1) / cell_size),
        math.ceil((h - 1) / cell_size),
    )


def make_occupancy(n_images: int, h: int, w: int, cell_size: int, device="cpu"):
    cx, cy = grid_shape(h, w, cell_size)
    return torch.zeros((n_images, cx, cy), dtype=torch.bool, device=device)


def which_cell(pix, cell_size: int):
    """Pixel (..., 2) float -> (..., 2) int32 cell (cx, cy)."""
    return torch.floor(pix / cell_size).to(torch.int32)


def cell_center(cell, cell_size: int):
    """Cell (..., 2) int -> pixel-space center."""
    return (cell.to(torch.float32) + 0.5) * cell_size


def is_vacant(occupancy, img_idx, cell):
    """Bounds-checked vacancy (out of bounds counts occupied)."""
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    inb = (
        (cell[..., 0] >= 0)
        & (cell[..., 0] < cx)
        & (cell[..., 1] >= 0)
        & (cell[..., 1] < cy)
    )
    ci = torch.clamp(cell[..., 0], 0, cx - 1).long()
    cj = torch.clamp(cell[..., 1], 0, cy - 1).long()
    occupied = occupancy[img_idx.long(), ci, cj]
    return inb & ~occupied


def fill_cells(occupancy, img_idx, cells, mask):
    """Occupy cells; masked entries are dropped.  Returns a new grid.

    img_idx (...,) int32, cells (..., 2) int32, mask (...,) bool.  The JAX
    package scatters ``mask`` with a bool max (masked rows send False to
    cell 0, a no-op); bool has no scatter-max here, so every row writes
    True and masked rows write it to one spare slot past the grid, which
    is then dropped: order-free, deterministic, and no host sync (an
    ``index_fill_`` with the scalar; an indexed assignment of ``True``
    copies the scalar to the device and waits for it).
    """
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    size = occupancy.numel()
    ci = torch.clamp(cells[..., 0], 0, cx - 1).long()
    cj = torch.clamp(cells[..., 1], 0, cy - 1).long()
    lin = (img_idx.long() * cx + ci) * cy + cj
    lin = torch.where(mask, lin, torch.full_like(lin, size))
    flat = torch.cat([occupancy.reshape(-1), occupancy.new_zeros(1)])
    flat.index_fill_(0, lin.reshape(-1), True)
    return flat[:size].reshape(occupancy.shape)
