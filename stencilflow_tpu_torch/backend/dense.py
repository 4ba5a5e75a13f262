"""Whole-domain torch lowering: the chain as one halo-padded tile.

Counterpart of ``stencilflow_tpu/backend/xla.py`` (its ``strategy="tile"``
path): every input is zero-padded by the chain's cumulative halo and the
whole chain runs through the widened-tile evaluator (tile_eval.py) as a
single tile, one torch op at a time.  It plays the role fused XLA plays in
the JAX package — the lowering for programs the kernels refuse, the CPU
path, and the yardstick ``chip_smoke.py`` holds the kernels against — and
it is named ``dense`` because nothing here is XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import ir
from ..dtypes import to_torch
from ..frontend.analysis import ChainAnalysis
from ..frontend.chain import ChainGraph
from .tile_eval import evaluate_chain_tile

Vec3 = Tuple[int, int, int]


def chain_halo(analysis: ChainAnalysis) -> Vec3:
    """Per-dim cumulative halo budget for fused evaluation of the chain:
    the max of every input's composed halo and every kernel's stage halo
    (an input-less constant stage still has consumers reading it at
    offsets, so the region must cover those planes too)."""
    h = [0, 0, 0]
    for vec in list(analysis.input_halo().values()) + \
            list(analysis.stage_halo().values()):
        for d in range(3):
            h[d] = max(h[d], vec[d])
    return tuple(h)


def pad_input_to_tile(arr: torch.Tensor, dim_mask, dimensions: Vec3,
                      halo: Vec3) -> torch.Tensor:
    """Zero-pad an input by the halo in its spanned dims (the padding is
    never observed: out-of-domain reads are masked by the BC logic)."""
    if arr.ndim == 0:
        return arr
    spanned = [d for d in range(3) if dim_mask[d]]
    arr = arr.reshape(tuple(dimensions[d] for d in spanned))
    out = torch.zeros(tuple(dimensions[d] + 2 * halo[d] for d in spanned),
                      dtype=arr.dtype, device=arr.device)
    out[tuple(slice(halo[d], halo[d] + dimensions[d])
              for d in spanned)] = arr
    return out


def compile_chain(program: ir.Program,
                  analysis: Optional[ChainAnalysis] = None):
    """Return ``fn(inputs: dict of tensors) -> outputs: dict of tensors``
    evaluating the chain on the inputs' device."""
    graph = ChainGraph.build(program)
    analysis = analysis or ChainAnalysis.run(program, graph)
    halo = chain_halo(analysis)
    dims = program.dimensions
    core = tuple(slice(halo[d], halo[d] + dims[d]) for d in range(3))
    raw = program.raw_dimensions

    def forward(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        tiles = {name: pad_input_to_tile(to_torch(inputs[name]),
                                         spec.dim_mask, dims, halo)
                 for name, spec in program.inputs.items()}
        results = evaluate_chain_tile(program, graph, tiles, (0, 0, 0),
                                      halo)
        return {name: arr[core].reshape(raw).contiguous()
                for name, arr in results.items()}

    return forward
