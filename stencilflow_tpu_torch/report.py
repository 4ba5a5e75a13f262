"""Analytic performance report: op counts, communication volume, and an
H100 roofline.

Port of ``stencilflow_tpu/report.py`` on the H100 hardware model of
``config.py``.  The counts (ops per cell, minimum communication volume,
critical path, fast-memory bytes, the out-of-core hint) are the JAX
package's, computed by the same copied analyses; what changes is what
they are divided by:

* **device memory**: the minimum traffic (every input and output array
  moved once) over the data sheet's 3.35e12 B/s (``hbm_time_s``), and
  over P4's measured copy floor (``vs_copy_floor``);
* **ALU**: the weighted op count (``_OP_COST``, P1's per-op costs in
  add-equivalents) over the data sheet's single-instruction FP32 rate,
  33.5e12 op/s (``alu_time_s``; ``as_dict``'s ``vpu_time_s``): the port
  builds every kernel with ``-fmad=false``, where each counted add and
  multiply is one instruction; and the executed ops (those of the faster
  strategy) over P1's measured issue rate (``vs_alu_issue``) and
  shared-memory pass rate (``vs_smem_pass``, the reachable rate of
  kernels that store every stage to shared memory);
* **band transforms** (``mxu_model``): the stream kernel's banded stages
  (K3b) as executed multiply-add sums on the CUDA cores, two
  instructions per band diagonal and plane cell
  (``linear.mxu_flops_per_cell``), over the same single-instruction rate.

The runtime lower bound is the larger of the memory time and the faster
of the two compute strategies.  Not ported yet: ``mesh_scaling`` (with
the sharded engine) and the single-pass bf16 transform prices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from . import config
from .frontend.analysis import ChainAnalysis
from .ir import Program

# per-op cost in add-equivalents, measured by P1 on the card
# (config.H100_OP_COST); ops not listed cost one add
_OP_COST = config.H100_OP_COST


@dataclasses.dataclass
class HardwareModel:
    hbm_bandwidth: float = config.H100_HBM_BANDWIDTH
    alu_ops: float = config.H100_ALU_OPS
    hbm_bytes: int = config.H100_HBM_BYTES
    copy_floor: float = config.H100_COPY_FLOOR
    alu_issue_rate: float = config.H100_ALU_ISSUE_RATE
    smem_pass_rate: float = config.H100_SMEM_PASS_RATE
    name: str = "h100-sxm"


@dataclasses.dataclass
class Report:
    program: Program
    analysis: ChainAnalysis
    hw: HardwareModel

    @classmethod
    def build(cls, program: Program,
              analysis: Optional[ChainAnalysis] = None,
              hw: Optional[HardwareModel] = None) -> "Report":
        return cls(program, analysis or ChainAnalysis.run(program),
                   hw or HardwareModel())

    # -- model ---------------------------------------------------------------
    def ops_per_cell(self) -> float:
        """Weighted elementwise ops per domain cell over the whole chain."""
        total = 0.0
        for op, (per_cell, _tot) in self.analysis.operation_counts().items():
            total += per_cell * _OP_COST.get(op, 1)
        return total

    def total_ops(self) -> float:
        return self.ops_per_cell() * self.program.total_elements

    def hbm_footprint_bytes(self) -> int:
        """Device-resident bytes of an in-core run: every input + output
        array (intermediates stream through shared memory)."""
        return self.analysis.minimum_communication_volume()

    def suggested_host_chunks(self) -> int:
        """1 when the in-core footprint fits device memory (with 25%
        headroom), else the smallest power-of-two i-chunk count that
        brings the per-chunk footprint under it (out-of-core execution,
        ``run --host-chunks``); 0 when no chunking helps (the i extent
        cannot absorb it, or non-i-spanning arrays alone exceed the budget
        — only i-spanning bytes shrink with chunking)."""
        budget = 0.75 * self.hw.hbm_bytes
        total = self.hbm_footprint_bytes()
        if total <= budget:
            return 1
        p = self.program
        elem = 1
        for d in p.dimensions:
            elem *= d
        i_bytes = sum(
            np.prod(spec.shape(p.dimensions), dtype=np.int64)
            * spec.dtype.itemsize
            for spec in p.inputs.values()
            if not spec.is_scalar and spec.dim_mask[0])
        i_bytes += sum(elem * np.dtype(p.kernels[o].dtype).itemsize
                       for o in p.outputs)   # outputs span the domain
        fixed = total - int(i_bytes)
        if fixed > budget:
            return 0
        I = p.dimensions[0]
        c = 2
        while c <= I:
            if I % c == 0 and fixed + i_bytes / c <= budget:
                return c
            c *= 2
        return 0

    def hbm_time_s(self) -> float:
        return (self.analysis.minimum_communication_volume()
                / self.hw.hbm_bandwidth)

    def alu_time_s(self) -> float:
        """Counted ops at the data sheet's single-instruction FP32 rate."""
        return self.total_ops() / self.hw.alu_ops

    def _compute(self) -> Tuple[float, float, str]:
        """(seconds, executed ops, kind) of the faster compute strategy:
        "alu", every stage per cell, or "mxu", the band transforms' flops
        plus the other stages' ops (the JAX package's name for it)."""
        per_cell = (self.alu_time_s(), self.total_ops(), "alu")
        m = self.mxu_model()
        if m is None:
            return per_cell
        banded = (m["mxu_time_s"] + m["vpu_rest_time_s"],
                  (m["mxu_flops_per_cell"] + m["vpu_rest_ops_per_cell"])
                  * self.program.total_elements, "mxu")
        return banded if banded[0] < per_cell[0] else per_cell

    def executed_ops(self) -> float:
        """Ops of the faster compute strategy (where the transforms are
        cheaper, the per-cell count is not executed)."""
        return self._compute()[1]

    def bound_fractions(self, measured_time_s: float) -> Dict[str, float]:
        """Named fractions of every roofline candidate for a measured
        per-evaluation time: ``vs_hbm`` (data sheet), ``vs_copy_floor``
        (P4), ``vs_alu_issue`` (P1's issue rate) and ``vs_smem_pass``
        (P1's shared-memory pass rate) over the executed ops, and
        ``vs_mxu`` when band transforms apply."""
        ops = self.executed_ops()
        out = {
            "vs_hbm": self.hbm_time_s() / measured_time_s,
            "vs_copy_floor": self.analysis.minimum_communication_volume()
            / self.hw.copy_floor / measured_time_s,
            "vs_alu_issue": ops / self.hw.alu_issue_rate / measured_time_s,
            "vs_smem_pass": ops / self.hw.smem_pass_rate / measured_time_s,
        }
        m = self.mxu_model()
        if m is not None:
            out["vs_mxu"] = ((m["mxu_time_s"] + m["vpu_rest_time_s"])
                             / measured_time_s)
        return {k: round(v, 4) for k, v in out.items()}

    def mxu_model(self) -> Optional[Dict]:
        """Band-transform model of the chain's eligible stages (None when
        the planner takes nothing), priced as the stream kernel executes
        them: the same composed and per-stage plans as the JAX package's,
        the multiply-add flops of their transforms per cell, and the
        residual per-cell ops of the other stages.  Cached per Report."""
        if hasattr(self, "_mxu_model"):
            return self._mxu_model
        from .backend.compose import compose_program, plan_composed
        from .backend.linear import (MatrixPool, finalize_pool,
                                     mxu_flops_per_cell, plan_all_stages)
        from .backend.stream import MXU_MIN_FOOTPRINT
        from .frontend.analysis import operation_count
        p = self.program
        dims = p.dimensions
        plane = (dims[1], dims[2])
        pool = MatrixPool()
        # composed segments replace their runs (one transform per t
        # stages, backend/compose.py) before per-stage planning
        comp = compose_program(p, self.analysis)
        builds = {}
        if comp is not None:
            p, builds = comp
        plans = plan_all_stages(p, plane, dims, pool, MXU_MIN_FOOTPRINT,
                                exclude=tuple(builds))
        for cname, b in builds.items():
            cp = plan_composed(b, plane, dims, pool)
            if cp is not None:
                plans[cname] = cp
        if not plans:
            self._mxu_model = None
            return None
        pkeys, parrs, tkeys = finalize_pool(plans, pool, p)
        fpc = mxu_flops_per_cell(dict(zip(pkeys, parrs)), tkeys)
        vpu_rest = 0.0
        for kname, kspec in p.kernels.items():
            if kname in plans:
                mp = plans[kname]
                if not hasattr(mp, "groups"):
                    # composed stage: per output plane, one table-weighted
                    # multiply-add + i guard per i-offset (covers t steps)
                    vpu_rest += 3 * len(mp.offsets)
                else:
                    # residual work of a banded stage: combining its
                    # i-offset group planes (adds) + bias
                    vpu_rest += max(0, len(mp.groups) - 1) + 1
                continue
            for op, c in operation_count(kspec).items():
                vpu_rest += c * _OP_COST.get(op, 1)
        n = p.total_elements
        self._mxu_model = {
            "stages": sorted(plans),
            "mxu_flops_per_cell": fpc,
            # unfused (-fmad=false): every flop is an instruction
            "mxu_time_s": fpc * n / self.hw.alu_ops,
            "vpu_rest_ops_per_cell": vpu_rest,
            "vpu_rest_time_s": vpu_rest * n / self.hw.alu_ops,
        }
        return self._mxu_model

    def roofline_time_s(self) -> float:
        """Runtime lower bound: the memory floor against the faster of the
        two compute strategies — every stage per cell, or band transforms
        for the eligible stages plus per-cell ops for the rest."""
        return max(self.hbm_time_s(), self._compute()[0], 1e-12)

    def bound(self) -> str:
        """"hbm", "alu" (per-cell ops) or "mxu" (band transforms, the JAX
        package's name for that strategy)."""
        compute, _, kind = self._compute()
        return kind if compute > self.hbm_time_s() else "hbm"

    def roofline_gcell_s(self) -> float:
        return self.program.total_elements / self.roofline_time_s() / 1e9

    def fast_memory_bytes(self) -> int:
        """On-chip working set of the streaming schedule (delay + line
        buffers), the reference's fast-memory total."""
        return self.analysis.fast_memory_bytes()

    # -- output --------------------------------------------------------------
    def as_dict(self) -> Dict:
        """The JAX package's keys; ``vpu_time_s`` holds ``alu_time_s``."""
        ops = {op: cnt for op, (cnt, _t) in
               self.analysis.operation_counts().items()}
        return {
            "hardware": self.hw.name,
            "dimensions": list(self.program.raw_dimensions),
            "kernels": len(self.program.kernels),
            "vectorization": self.program.vectorization,
            "ops_per_cell": ops,
            "weighted_ops_per_cell": self.ops_per_cell(),
            "total_ops": self.total_ops(),
            "critical_path_cycles": self.analysis.critical_path_cycles,
            "runtime_lower_bound_cycles":
                self.analysis.runtime_lower_bound(),
            "min_communication_volume_bytes":
                self.analysis.minimum_communication_volume(),
            "fast_memory_bytes": self.fast_memory_bytes(),
            "hbm_footprint_bytes": self.hbm_footprint_bytes(),
            "suggested_host_chunks": self.suggested_host_chunks(),
            "hbm_time_s": self.hbm_time_s(),
            "vpu_time_s": self.alu_time_s(),
            "mxu_model": self.mxu_model(),
            "roofline_time_s": self.roofline_time_s(),
            "bound_by": self.bound(),
            "roofline_gcell_s": self.roofline_gcell_s(),
            "peak_gop_s": self.total_ops() / self.alu_time_s() / 1e9
            if self.alu_time_s() > 0 else 0.0,
            "achievable_gop_s":
                self.total_ops() / self.roofline_time_s() / 1e9,
        }

    def full_dump(self) -> str:
        """Complete analysis dump (the reference's KernelChainGraph.report,
        kernel_chain_graph.py:603-719): per-kernel accesses, latencies, and
        per-edge delay/line-buffer sizes."""
        a = self.analysis
        lines = [str(self), "", "kernels:"]
        for kname in a.graph.kernel_order:
            lines.append(f"  {kname}: latency={a.kernel_latencies[kname]} "
                         f"cycles")
            for field, info in a.kernel_accesses[kname].items():
                lines.append(
                    f"    reads {field}: accesses={info.accesses} "
                    f"extent={info.buffer_extent} "
                    f"line-buffer={info.buffer_size} elems")
        lines.append("edges (delay + line buffers):")
        for (src, dst), eb in a.edges.items():
            lines.append(
                f"  {src} -> {dst}: delay={eb.delay_size} "
                f"internal={eb.internal_size} "
                f"({eb.total_bytes()} B {np.dtype(eb.dtype).name})")
        lines.append(f"critical path: {a.critical_path_cycles} cycles")
        halos = a.input_halo()
        lines.append(f"fused-tile input halos: {halos}")
        lines.append("input path delays (per in-edge alignment skew):")
        for kname in a.graph.kernel_order:
            ins = {src: (eb.delay_extent, eb.delay_size)
                   for (src, dst), eb in a.edges.items() if dst == kname}
            lines.append(f"  {kname}: " + (", ".join(
                f"{s}: skew={ext} ({n} elems)"
                for s, (ext, n) in ins.items()) or "(source)"))
        total_elems = sum(eb.total_elements for eb in a.edges.values())
        total_bytes = sum(eb.total_bytes() for eb in a.edges.values())
        lines.append(f"total buffer size: {total_elems} elems "
                     f"({total_bytes} B)")
        from .frontend.export import kernel_to_relative, kernel_to_string
        rank = len(self.program.raw_dimensions)
        lines.append("kernel strings (dialect absolute / relative-access):")
        for kname in a.graph.kernel_order:
            ks = self.program.kernels[kname]
            lines.append(f"  {kname}: {kernel_to_string(ks, rank)}")
            lines.append(f"    relative: {kernel_to_relative(ks)}")
        # optimizer demo at one float32 stream's volume, as in the JAX
        # package
        from .optimizer import Optimizer
        opt = Optimizer(self.program, a)
        bound = int(self.program.total_elements
                    * np.dtype("float32").itemsize)
        opt.minimize_fast_mem(comm_volume_bound=bound)
        lines.append(f"optimizer demo (minimize_fast_mem, comm bound "
                     f"{bound} B = one float32 stream):")
        lines.append("  " + opt.summary().replace("\n", "\n  "))
        return "\n".join(lines)

    def __str__(self) -> str:
        d = self.as_dict()
        lines = [
            f"program: {self.program.name}  dims={d['dimensions']}  "
            f"kernels={d['kernels']}  W={d['vectorization']}",
            f"ops/cell: {d['ops_per_cell']}  (weighted "
            f"{d['weighted_ops_per_cell']:.1f})",
            f"critical path: {d['critical_path_cycles']} cycles; "
            f"runtime lower bound: {d['runtime_lower_bound_cycles']} cycles",
            f"min communication volume: "
            f"{d['min_communication_volume_bytes']/2**20:.2f} MiB",
            f"on-chip (streaming) working set: "
            f"{d['fast_memory_bytes']/2**10:.1f} KiB",
            f"roofline [{d['hardware']}]: "
            f"HBM {d['hbm_time_s']*1e6:.1f} us vs ALU "
            f"{d['vpu_time_s']*1e6:.1f} us -> bound by {d['bound_by']}; "
            f"best possible {d['roofline_gcell_s']:.1f} GCell/s "
            f"({d['achievable_gop_s']:.0f} GOp/s)",
        ]
        if d["suggested_host_chunks"] != 1:
            gib = d["hbm_footprint_bytes"] / 2**30
            hint = (f"run --host-chunks {d['suggested_host_chunks']}"
                    if d["suggested_host_chunks"] else
                    "no i-chunking fits; shard across cards")
            lines.append(
                f"HBM footprint {gib:.1f} GiB exceeds the card "
                f"({self.hw.hbm_bytes/2**30:.0f} GiB): out-of-core "
                f"advised -> {hint}")
            # out-of-core x domain decomposition: per-device footprint
            # when each chunk is additionally j-sharded across N devices
            C = max(2, d["suggested_host_chunks"] or 2)
            I, J, K = self.program.dimensions
            from .backend.dense import chain_halo
            h = chain_halo(self.analysis)
            for n_dev in (4, 8):
                if J % n_dev:
                    continue
                per = sum(
                    (I // C + 2 * h[0]) * (J // n_dev + 2 * h[1])
                    * (K + 2 * h[2])
                    * np.dtype(self.program.field_dtype(f)).itemsize
                    for f in (list(self.program.inputs)
                              + list(self.program.kernels))
                    if f not in self.program.inputs
                    or not self.program.inputs[f].is_scalar)
                lines.append(
                    f"  with {n_dev}-way j-sharded chunks "
                    f"(run-distributed + host chunking): "
                    f"{per/2**20:.1f} MiB per device tile")
                break
        return "\n".join(lines)
