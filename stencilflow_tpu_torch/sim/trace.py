"""Chrome-trace export of the per-cycle simulator trace (copy of the JAX
package's ``sim/trace.py``; the same bytes out for the same CSV).

The Python machine streams one CSV row per cycle (every kernel's program
counter, every FIFO's occupancy — machine.py:run).  This module converts
that CSV into the Chrome Trace Event format so a run can be explored
interactively in Perfetto / chrome://tracing: one counter track per FIFO
(occupancy over cycles), one per kernel (program counter), and one
activity span per kernel from its first to its last fire.

Timestamps are cycles, written as microseconds (1 cycle == 1 us) so the
viewer's time axis reads directly in cycles.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def csv_to_chrome(csv_path, out_path, every: int = 1) -> int:
    """Convert a ``simulate --trace`` CSV to a Chrome trace JSON.

    ``every`` decimates counter samples (rows between samples); change
    points are always kept so edges stay sharp.  Returns the number of
    events written.
    """
    every = max(1, int(every))
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
        cols = header[1:]
        # machine state before cycle 0 is all zeros (pc=0, occ=0), so a
        # kernel firing at cycle 0 registers as a change on the first row
        prev: List[Optional[str]] = ["0"] * len(cols)
        first_change: Dict[str, int] = {}
        last_change: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for tid, name in enumerate(cols):
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": name}})
        events.append({"ph": "M", "name": "process_name", "pid": 0,
                       "args": {"name": "stencilflow_tpu simulator"}})
        row_i = 0
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != len(cols) + 1:
                continue
            cycle = int(parts[0])
            sample = (row_i % every) == 0
            for ci, val in enumerate(parts[1:]):
                changed = val != prev[ci]
                if changed:
                    name = cols[ci]
                    if name not in first_change:
                        first_change[name] = cycle
                    last_change[name] = cycle
                if sample or changed:
                    key = "pc" if cols[ci].startswith("pc:") else "occ"
                    events.append({"ph": "C", "name": cols[ci],
                                   "pid": 0, "ts": cycle,
                                   "args": {key: int(val)}})
                    prev[ci] = val
            row_i += 1
    # one activity span per kernel: first pc change -> last pc change
    for tid, name in enumerate(cols):
        if not name.startswith("pc:") or name not in first_change:
            continue
        start = first_change[name]
        events.append({"ph": "X", "name": f"active {name[3:]}",
                       "pid": 0, "tid": tid, "ts": start,
                       "dur": max(1, last_change[name] - start)})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)
