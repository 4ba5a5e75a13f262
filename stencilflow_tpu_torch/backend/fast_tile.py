"""Mask-free interior evaluator: shrinking-margin slice semantics.

Port of ``stencilflow_tpu/backend/fast_tile.py``.  A cell farther than
the chain's cumulative halo ``H`` from every domain border never makes an
out-of-domain read in any stage, so the interior needs no boundary
condition at all: every field buffer carries a per-dim margin (inputs the
full halo, kernels their stage halo, ``field_margins``), and a read of
field ``f`` at offset ``o`` for a result of margin ``m`` is the slice

    f_buf[margin_f - m + o : margin_f - m + o + T + 2m]     (per dim)

— in bounds because ``margin_f >= m + |o|`` (the stage-halo recurrence).
Cells within ``H`` of a border see the zero padding instead of their
boundary condition; the plain version of the overlapped-tile lowering's
fast mode (``tile.py``) overwrites that shell with the exact evaluator
(``shell_fixup``), where its kernel evaluates the blocks that touch the
shell with their boundary conditions.

Here the slices act on the last three dims, so one call evaluates a whole
batch of tiles (leading dims) at once: ``tile.py``'s plain version of the
fast kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import ir
from ..frontend.analysis import ChainAnalysis
from .tile_eval import eval_kernel_statements

Vec3 = Tuple[int, int, int]


def field_margins(analysis: ChainAnalysis, halo: Vec3) -> Dict[str, Vec3]:
    """Margin (extra border carried) per field buffer: inputs carry the
    full halo budget, kernels their stage halo."""
    margins: Dict[str, Vec3] = {n: tuple(halo)
                                for n in analysis.program.inputs}
    margins.update(analysis.stage_halo())
    return margins


def slice_read(buf: torch.Tensor, buf_margin: Vec3, offsets: ir.Offsets,
               target_margin: Vec3, tile: Vec3) -> torch.Tensor:
    """``buf`` (batch dims, then a field's widened tile) read at
    ``offsets`` for a result of margin ``target_margin``."""
    sl = []
    for d in range(3):
        start = buf_margin[d] - target_margin[d] + (offsets[d] or 0)
        size = tile[d] + 2 * target_margin[d]
        if start < 0 or start + size > buf.shape[buf.ndim - 3 + d]:
            raise ValueError(f"fast-path slice out of range: dim {d}, "
                             f"start {start}, size {size}")
        sl.append(slice(start, start + size))
    return buf[(Ellipsis,) + tuple(sl)]


def evaluate_chain_fast(analysis: ChainAnalysis,
                        tile_fields: Dict[str, torch.Tensor], tile: Vec3,
                        margins: Dict[str, Vec3]) -> Dict[str, torch.Tensor]:
    """Evaluate the chain mask-free on a batch of tiles.  Every array
    input of ``tile_fields`` has shape ``batch + (tile + 2 * margin)``
    (lower-rank inputs broadcast to it, zero padding beyond the domain),
    scalars are 0-d.  Returns the outputs at ``batch + (tile + 2 *
    margin)``."""
    program = analysis.program
    order = analysis.graph.kernel_order
    names = list(program.outputs)
    last_use: Dict[str, int] = {}
    for idx, kname in enumerate(order):
        for f in program.kernels[kname].accesses():
            last_use[f] = idx
    fields = dict(tile_fields)
    batch = next(v.shape[:-3] for n, v in fields.items()
                 if not program.inputs[n].is_scalar)
    device = next(v.device for n, v in fields.items()
                  if not program.inputs[n].is_scalar)
    for idx, kname in enumerate(order):
        m = margins[kname]

        def read(field, offsets, m=m):
            dt = np.dtype(program.field_dtype(field))
            buf = fields[field]
            if buf.ndim == 0:
                return buf.to(device), dt
            return slice_read(buf, margins[field], offsets, m, tile), dt

        shape = tuple(batch) + tuple(t + 2 * x for t, x in zip(tile, m))
        fields[kname] = eval_kernel_statements(program.kernels[kname], read,
                                               shape, device)
        for f, last in last_use.items():
            if last == idx and f in program.kernels and f not in names:
                del fields[f]
    return {n: fields[n] for n in names}
