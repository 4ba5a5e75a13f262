"""P2, weights read from a small table at a runtime row: what does the
stream kernel's composed stage pay for its i-table?

    python -m stencilflow_tpu_torch.probes.table_read [--trials 5]

Port of ``scripts/smem_table_probe.py`` (``build`` :38, ``pallas_call``
:39, body ``kernel`` :23) as the CUDA kernel ``csrc/probes/table_read.cu``.
``table_read(tab, x, steps)``: tab is (NTAB, NOFF), x (ROWS, COLS); step g
uses the row ``g < D ? g : (g >= steps - D ? NTAB + g - steps : D)`` with
D = NTAB // 2 (the composed plan's clamp) and writes rows [g * ROWS, (g +
1) * ROWS) of the (steps * ROWS, COLS) output: ``acc = 0; acc = acc +
tab[row, d] * (x + d)`` for d = 0 .. NOFF - 1, in that order.  Variants,
each a way the composed stage (K3b) could hold its table:

* ``ldg``: one ``__ldg`` per term at the runtime row, what
  ``backend/codegen.py`` emits today;
* ``const``: ``__constant__`` memory (the row is uniform over a block at
  each step, so reads broadcast);
* ``smem``: staged to shared memory once per block;
* ``param``: the row's NOFF weights passed by value as a launch
  parameter, one launch per run of steps with one row (the interior, and
  one per boundary row): the immediates of a kernel specialised per row.
  Its weights come from the host (``tab_host``, or a copy of ``tab``).

Shapes: ``PARITY`` is the TPU script's (7 x 5, 64 x 256, 9 steps);
``TIMED`` is box-r2 256^3 x 8's composed plan (``stream.plan_stream``:
one composed stage, D = 16, a 33 x 33 table) over a 256 x 256 plane and
256 steps, a 64 MiB output.  Each variant prints ms (differenced graph
replays), its bound (``work``: the bytes, against the operations the
function needs) and its time over ``ldg``'s.  No single PyTorch call computes this sum in this
order, so there is no library time.  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import (ClockSampler, card, check_cuda, differenced_ms, load,
               require_cuda, roofline, vec_of)

launches = 0

VARIANTS = ("ldg", "const", "smem", "param")
PARITY = dict(ntab=7, noff=5, rows=64, cols=256, steps=9)
TIMED = dict(ntab=33, noff=33, rows=256, cols=256, steps=256)
NOFFS = (3, 5, 33)           # the term counts table_read.cu builds
MAX_NTAB = 128
CONST_FLOATS = 16384         # the 64 KB constant bank
CHUNK = 16                   # steps per block

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_vp,) * 4 + (_int, _int, _ll) + (_int,) * 4 + (_vp,)


def table_row(g: int, steps: int, ntab: int) -> int:
    """The table row of step ``g``."""
    D = ntab // 2
    return g if g < D else (ntab + g - steps if g >= steps - D else D)


def row_runs(steps: int, ntab: int) -> List[Tuple[int, int, int]]:
    """(first step, end step, row) of each run of steps with one row: the
    launches of the ``param`` variant."""
    runs: List[List[int]] = []
    for g in range(steps):
        r = table_row(g, steps, ntab)
        if runs and runs[-1][2] == r:
            runs[-1][1] = g + 1
        else:
            runs.append([g, g + 1, r])
    return [tuple(r) for r in runs]


def inputs(ntab: int, noff: int, rows: int, cols: int, device="cpu",
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tab, x) drawn from N(0, 1) with numpy, as the TPU script draws."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(ntab, noff)).astype(np.float32)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    return torch.as_tensor(tab, device=device), torch.as_tensor(x,
                                                                device=device)


def table_read_plain(tab: torch.Tensor, x: torch.Tensor,
                     steps: int) -> torch.Tensor:
    """The plain torch version: each distinct row's sum once, in the
    kernel's order, copied to its steps."""
    ntab, noff = tab.shape
    rows, cols = x.shape
    out = torch.empty((steps * rows, cols), dtype=x.dtype, device=x.device)
    for lo, hi, r in row_runs(steps, ntab):
        acc = torch.zeros_like(x)
        for d in range(noff):
            acc = acc + tab[r, d] * (x + torch.tensor(np.float32(d),
                                                      device=x.device))
        out.view(steps, rows, cols)[lo:hi] = acc
    return out


def table_read(tab: torch.Tensor, x: torch.Tensor, steps: int,
               variant: str = "ldg", out: Optional[torch.Tensor] = None,
               tab_host: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (steps * ROWS, COLS) output.  On a CUDA ``x`` the ``variant``'s
    kernel runs (``param``: one launch per run of rows, weights from
    ``tab_host``, else from a host copy of ``tab``); on a CPU ``x`` the
    plain version runs."""
    if variant not in VARIANTS or steps < 1:
        raise ValueError(f"bad table case: variant {variant!r}, steps "
                         f"{steps}")
    if tab.dim() != 2 or x.dim() != 2:
        raise ValueError(f"table_read takes a (NTAB, NOFF) table and a "
                         f"(ROWS, COLS) plane, got {tuple(tab.shape)} and "
                         f"{tuple(x.shape)}")
    (ntab, noff), (rows, cols) = tab.shape, x.shape
    if out is None:
        out = torch.empty((steps * rows, cols), dtype=x.dtype,
                          device=x.device)
    if out.shape != (steps * rows, cols):
        raise ValueError(f"out must be {(steps * rows, cols)}")
    if x.device.type == "cpu":
        out.copy_(table_read_plain(tab, x, steps))
        return out
    for t in (tab, x, out):
        check_cuda(t)
    if noff not in NOFFS or ntab > MAX_NTAB or ntab * noff > CONST_FLOATS:
        raise ValueError(f"table_read.cu builds NOFF in {NOFFS} and NTAB up "
                         f"to {MAX_NTAB}, got ({ntab}, {noff})")
    if variant == "param" and tab_host is None:
        tab_host = tab.detach().cpu()
    host_ptr = None
    if variant == "param":
        tab_host = tab_host.contiguous().float()
        host_ptr = tab_host.data_ptr()
    n = rows * cols
    lib = load("table_read", "sf_table_read_launch", _ARGS)
    with torch.cuda.device(x.device):
        rc = lib.sf_table_read_launch(
            tab.data_ptr(), host_ptr, x.data_ptr(), out.data_ptr(), ntab,
            noff, n, steps, VARIANTS.index(variant),
            vec_of(n, x, out), CHUNK,
            torch.cuda.current_stream().cuda_stream)
    if rc <= 0:
        raise RuntimeError(f"table_read kernel launch failed: CUDA error "
                           f"{-rc}")
    global launches
    launches += rc                 # the kernels the launch call started
    return out


def work(ntab: int, noff: int, rows: int, cols: int, steps: int
         ) -> Tuple[float, float]:
    """(bytes, operations) the function needs: the table and x read once,
    the output written once; NOFF adds per input cell (``x + d`` does not
    depend on the step) and 2 NOFF operations (multiply, add) per cell of
    each distinct row, since the steps that share a row share its sum.
    The kernels do 3 NOFF per output cell: they time the per-step read."""
    cells = rows * cols
    distinct = len({table_row(g, steps, ntab) for g in range(steps)})
    return (4.0 * (ntab * noff + cells + steps * cells),
            noff * cells + 2.0 * noff * distinct * cells)


def measure(trials: int = 5) -> List[Dict[str, object]]:
    """Every variant at ``TIMED`` on the card: checked against the plain
    version (bit-exact), then timed (graphs of 2 and 10 calls,
    differenced)."""
    shape = TIMED
    tab, x = inputs(**{k: shape[k] for k in ("ntab", "noff", "rows",
                                             "cols")}, device="cuda")
    steps = shape["steps"]
    tab_host = tab.cpu()
    want = table_read_plain(tab, x, steps)
    out = torch.empty_like(want)
    rows = []
    nbytes, ops = work(**shape)
    for v in VARIANTS:
        got = table_read(tab, x, steps, v, out, tab_host=tab_host)
        if not torch.equal(got, want):
            raise RuntimeError(f"table_read {v} differs from its plain "
                               f"version")

        def run(n, v=v):
            for _ in range(n):
                table_read(tab, x, steps, v, out, tab_host=tab_host)
        before = launches
        ms = differenced_ms(run, 2, 10, trials, graph=True)
        rows.append({"variant": v, "ms": ms,
                     # the warm-up's 2 calls and the captures' 2 + 10
                     "launches_per_call": (launches - before) // 14,
                     **roofline(nbytes, ops, ms)})
    for r in rows:
        r["vs_ldg"] = r["ms"] / rows[0]["ms"]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="table_read", description=__doc__)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    if not require_cuda("the table probe"):
        return 1
    dev = card()
    with ClockSampler() as clocks:
        rows = measure(trials=args.trials)
    for r in rows:
        print(f"{r['variant']:5s} {r['ms']:.4f} ms ({r['vs_ldg']:.3f} x ldg,"
              f" {r['launches_per_call']} launches a call) bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) vs_bound "
              f"{r['vs_bound']:.3f} vs_alu_issue {r['vs_alu_issue']:.3f}",
              flush=True)
    print(f"table {TIMED['ntab']} x {TIMED['noff']}, x {TIMED['rows']} x "
          f"{TIMED['cols']}, {TIMED['steps']} steps | {dev['name']}, "
          f"{dev['power_limit_w']} W | {clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "shape": TIMED, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
