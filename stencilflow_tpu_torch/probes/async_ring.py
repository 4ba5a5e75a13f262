"""P3, the cp.async plane ring: does copying the next planes' tiles into
shared memory before the current plane is computed recover the overlap
that plain loads lose at 1-2 blocks per SM?

    python -m stencilflow_tpu_torch.probes.async_ring [--trials 3]

Port of ``scripts/dma_manual_probe.py`` (``build_auto`` :43 with
``pallas_call`` :44 and body :39; ``build_manual`` :95 with ``pallas_call``
:96 and body :57): the TPU's automatic block pipeline against a manual
2-slot async-copy ring, N dependent multiplies per plane.  Its kernel is
in P6's source (``csrc/probes/dma_overlap.cu``), which shares the plane
tile and the multiply chain:

* ``direct``: plain loads into registers, P6's ``dep`` kernel;
* ``ring``: each block copies its tile of planes g+1 .. g+S-1 with
  16-byte ``cp.async.cg`` into an S-slot shared-memory ring (commit and
  wait groups, a ``__syncthreads`` before a slot is reused) before plane
  g is computed from shared memory and stored straight to global memory.
  S = 2 is the TPU's double buffer.

Both compute ``dma_overlap.chain_plain`` bit for bit, as the TPU script
asserted manual == auto.  TMA (``cp.async.bulk.tensor`` with an
``mbarrier``) is not here: it belongs to the spilled stream kernel's
redesign.  The sweep: S in ``SLOTS`` x N in ``NOPS`` x blocks per SM in
``dma_overlap.OCCUPANCY``, and ``direct`` at each N and residency, at
512^3; each case prints ms, GB/s, its bound and ``hide`` = ms / ms of
direct N = 0 at the same residency.  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Optional

import torch

from . import (ClockSampler, card, check_cuda, load, occupancy_smem,
               pingpong_ms, require_cuda, roofline, vec_of)
from .dma_overlap import (A, B, CHUNK, MAIN, OCCUPANCY, chain_plain,
                          check_shape, leave_points, occupancy, work)

launches = 0

MODES = ("direct", "ring")
SLOTS = (2, 3, 4)
NOPS = (0, 4, 8, 16, 32, 64, 128)
THREADS = 256

_vp, _int, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_vp, _vp) + (_int,) * 8 + (_f, _f, _int, _vp)


def ring_plain(x: torch.Tensor, nops: int) -> torch.Tensor:
    """The plain torch version of both modes: P6's dependent chain."""
    return chain_plain(x, nops)


def ring_bytes(slots: int, vec: int) -> int:
    """Shared memory of an S-slot ring: S tiles of 256 units."""
    return slots * THREADS * vec * 4


def ring(x: torch.Tensor, nops: int, mode: str = "ring", slots: int = 2,
         out: Optional[torch.Tensor] = None, blocks_per_sm: int = 0
         ) -> torch.Tensor:
    """N dependent multiplies per plane of a (P, J, K) float32 tensor
    through ``mode``, blocks owning chunks of ``CHUNK`` planes.  On a CUDA
    tensor the kernel runs with ``blocks_per_sm`` resident blocks (0: as
    many as fit); on a CPU tensor the plain version runs."""
    if mode not in MODES or slots not in SLOTS or nops < 0:
        raise ValueError(f"bad ring case: mode {mode!r}, slots {slots}, "
                         f"nops {nops}")
    check_shape(x)
    P, J, K = x.shape
    if out is None:
        out = torch.empty_like(x)
    if x.device.type == "cpu":
        out.copy_(ring_plain(x, nops))
        return out
    check_cuda(x)
    check_cuda(out)
    if out.shape != x.shape:
        raise ValueError("out must match x in shape")
    vec = vec_of(K, x, out)
    smem = occupancy_smem(blocks_per_sm, ring_bytes(slots, vec)
                          if mode == "ring" else 0)
    lib = load("dma_overlap", "sf_async_ring_launch", _ARGS)
    with torch.cuda.device(x.device):
        rc = lib.sf_async_ring_launch(
            x.data_ptr(), out.data_ptr(), P, J, K, CHUNK,
            MODES.index(mode), slots, vec, nops, float(A), float(B), smem,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"async_ring kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return out


def cases():
    """(mode, S) of the sweep: direct once, the ring at each S."""
    return [("direct", 2)] + [("ring", s) for s in SLOTS]


def measure(trials: int = 3) -> List[Dict[str, object]]:
    """Every case at ``MAIN`` on the card: each S first checked against
    direct and the plain version (bit-exact at N = 16), then timed from
    graphs, output fed back as input."""
    shape = MAIN
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.rand(shape, device="cuda", generator=gen) * 0.5 + 0.5
    b = torch.empty_like(a)
    want = ring_plain(a, 16)
    for mode, s in cases():
        if not torch.equal(ring(a, 16, mode, s, b), want):
            raise RuntimeError(f"async_ring {mode} S={s} differs from its "
                               f"plain version")
    rows = []
    vec = vec_of(shape[2], a, b)
    for bps in OCCUPANCY:
        for mode, s in cases():
            smem = occupancy_smem(bps, ring_bytes(s, vec)
                                  if mode == "ring" else 0)
            for n in NOPS:
                ms = pingpong_ms(
                    lambda x, y: ring(x, n, mode, s, y, blocks_per_sm=bps),
                    a, b, trials)
                nbytes, ops = work(shape, "dep", n)
                rows.append({
                    "mode": mode if mode == "direct" else f"ring{s}",
                    "slots": s if mode == "ring" else None, "nops": n,
                    "blocks_per_sm": bps,
                    "resident": occupancy(0 if mode == "direct" else 2,
                                          vec, s, smem),
                    "ms": ms, "gb_s": nbytes / ms / 1e6,
                    **roofline(nbytes, ops, ms)})
    base = {r["blocks_per_sm"]: r["ms"] for r in rows
            if r["mode"] == "direct" and r["nops"] == 0}
    for r in rows:
        r["hide"] = r["ms"] / base[r["blocks_per_sm"]] if base else None
    del a, b
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="async_ring", description=__doc__)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    if not require_cuda("the async ring probe"):
        return 1
    dev = card()
    with ClockSampler() as clocks:
        rows = measure(trials=args.trials)
    for r in rows:
        print(f"{r['mode']:6s} N={r['nops']:3d} {r['blocks_per_sm'] or 'full'}"
              f"/SM (resident {r['resident']}): {r['ms']:.4f} ms "
              f"{r['gb_s']:7.1f} GB/s hide {r['hide']:.3f} bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) vs_bound "
              f"{r['vs_bound']:.3f} vs_copy_floor {r['vs_copy_floor']:.3f}",
              flush=True)
    leave = leave_points(rows)
    print(f"first N more than 5 % above direct N = 0: {leave} | "
          f"{dev['name']}, {dev['power_limit_w']} W | {clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "shape": list(MAIN), "chunk": CHUNK, "cases": rows,
                      "leave_passthrough": leave}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
