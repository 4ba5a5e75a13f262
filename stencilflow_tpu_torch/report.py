"""Analytic performance report: op counts, communication volume, and an
H100 roofline.

Port of ``stencilflow_tpu/report.py`` on the H100 hardware model of
``config.py``.  The counts (ops per cell, minimum communication volume,
critical path, fast-memory bytes, the out-of-core hint) are the JAX
package's, computed by the same copied analyses; what changes is what
they are divided by:

* **device memory**: the minimum traffic (every input and output array
  moved once, at the compute type's size under the stream kernel's
  ``compute_dtype``) over the data sheet's 3.35e12 B/s (``hbm_time_s``), and
  over P4's measured copy floor (``vs_copy_floor``);
* **ALU**: the weighted op count (``_OP_COST``, P1's per-op costs in
  add-equivalents) over the data sheet's single-instruction FP32 rate,
  33.5e12 op/s (``alu_time_s``; ``as_dict``'s ``vpu_time_s``): the port
  builds every kernel with ``-fmad=false``, where each counted add and
  multiply is one instruction; the ops of a stage typed bfloat16 or
  float16 (or of any stage under ``compute_dtype`` "bfloat16" or
  "float16"; under another compute type none) at twice that, the packed
  narrow rate (``config.H100_NARROW_ALU_OPS``); and the
  executed ops (those of the faster strategy) over P1's measured issue
  rate (``vs_alu_issue``) and shared-memory pass rate (``vs_smem_pass``,
  the reachable rate of kernels that store every stage to shared
  memory);
* **band transforms** (``mxu_model``): the stream kernel's banded stages
  (K3b) as executed multiply-add sums on the CUDA cores, two
  instructions per band diagonal and plane cell
  (``linear.mxu_flops_per_cell``), over the same single-instruction rate;
  and as single-pass bf16 tensor-core passes (``mxu_precision="bf16"``),
  the m16n8k16 products' executed flops
  (``linear.mxu_bf16_flops_per_cell``) over the data sheet's dense bf16
  tensor rate, 989e12 flop/s (``mxu_time_s_bf16``).

The runtime lower bound is the larger of the memory time and the faster
of the two compute strategies.

``mesh_scaling`` is the JAX package's model of the sharded engine
(``parallel/domain.py``) over a mesh of cards: every count term is
computed as there (the local block, the chain halo from
``backend.dense.chain_halo``, the exchanged bytes, the overlap's interior
and strip cells), the compute term is the roofline above scaled by the
block's widened share of the domain, and the exchange is priced at one
direction of the H100 SXM5's NVLink 4 (``config.H100_NVLINK_BANDWIDTH``,
a data-sheet figure).  Its keys keep the JAX package's names
(``ici_bytes_per_device``, ``t_ici_s``); the printed text says NVLink.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from . import config
from .dtypes import dtype_to_str, is_narrow
from .frontend.analysis import ChainAnalysis, operation_count
from .ir import Program

# per-op cost in add-equivalents, measured by P1 on the card
# (config.H100_OP_COST); ops not listed cost one add
_OP_COST = config.H100_OP_COST


def _stage_ops(kspec) -> float:
    """Weighted ops a cell of one stage."""
    return sum(c * _OP_COST.get(op, 1)
               for op, c in operation_count(kspec).items())


# the stream kernel's narrow compute types (priced at 2 bytes a cell and
# the packed narrow rate)
_NARROW_COMPUTE = ("bfloat16", "float16")
# bytes of a cell under each compute type (its canonical type's size)
_COMPUTE_SIZE = {"float32": 4, "float64": 4, "int32": 4, "int64": 4,
                 "bfloat16": 2, "float16": 2, "bool": 1}


@dataclasses.dataclass
class HardwareModel:
    hbm_bandwidth: float = config.H100_HBM_BANDWIDTH
    alu_ops: float = config.H100_ALU_OPS
    narrow_alu_ops: float = config.H100_NARROW_ALU_OPS
    hbm_bytes: int = config.H100_HBM_BYTES
    copy_floor: float = config.H100_COPY_FLOOR
    alu_issue_rate: float = config.H100_ALU_ISSUE_RATE
    smem_pass_rate: float = config.H100_SMEM_PASS_RATE
    bf16_tensor_flops: float = config.H100_BF16_TENSOR_FLOPS
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

    def hbm_time_s(self, compute_dtype=None) -> float:
        """The memory floor: every input read once and every output
        written once at the data sheet's rate; under the stream kernel's
        ``compute_dtype`` every cell of them at that type's size (the
        kernel reads and writes arrays of it): 4 bytes for float32 and
        int32 (float64 and int64 compute in them), 2 for bfloat16 and
        float16, 1 for bool."""
        if compute_dtype is None:
            vol = self.analysis.minimum_communication_volume()
        else:
            size = _COMPUTE_SIZE[str(compute_dtype).replace("torch.", "")]
            dims = self.program.dimensions
            vol = size * (sum(int(np.prod(s.shape(dims), dtype=np.int64))
                              for s in self.program.inputs.values())
                          + len(self.program.outputs)
                          * self.program.total_elements)
        return vol / self.hw.hbm_bandwidth

    def narrow_ops_per_cell(self, compute_dtype=None) -> float:
        """The weighted ops a cell of the stages whose ops round to 2
        bytes: those typed bfloat16 or float16, or every stage under
        ``compute_dtype`` "bfloat16" or "float16"; none under another
        compute type (its ops are float32, int32 or bool ones, priced at
        the single-instruction FP32 rate)."""
        if compute_dtype is not None:
            return self.ops_per_cell() if str(compute_dtype).replace(
                "torch.", "") in _NARROW_COMPUTE else 0.0
        return sum(_stage_ops(k) for k in self.program.kernels.values()
                   if is_narrow(k.dtype))

    def _alu_seconds(self, ops_per_cell: float, narrow: float) -> float:
        """``ops_per_cell`` weighted ops a cell over the domain, the
        ``narrow`` share of them at the packed narrow rate, the rest at
        the single-instruction FP32 rate."""
        n = self.program.total_elements
        return ((ops_per_cell - narrow) * n / self.hw.alu_ops
                + narrow * n / self.hw.narrow_alu_ops)

    def alu_time_s(self, compute_dtype=None) -> float:
        """Counted ops, a narrow stage's at the packed narrow rate."""
        return self._alu_seconds(self.ops_per_cell(),
                                 self.narrow_ops_per_cell(compute_dtype))

    def _compute(self, mxu_precision: str = "split", compute_dtype=None
                 ) -> Tuple[float, float, str]:
        """(seconds, executed ops, kind) of the faster compute strategy:
        "alu", every stage per cell, or "mxu", the band transforms' flops
        plus the other stages' ops (the JAX package's name for it), the
        transforms as single-pass bf16 products at the bf16 tensor rate
        under ``mxu_precision="bf16"``."""
        per_cell = (self.alu_time_s(compute_dtype), self.total_ops(), "alu")
        m = self.mxu_model()
        if m is None:
            return per_cell
        bf = "_bf16" if mxu_precision == "bf16" else ""
        banded = (m["mxu_time_s" + bf] + m["vpu_rest_time_s"],
                  (m["mxu_flops_per_cell" + bf] + m["vpu_rest_ops_per_cell"])
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
        ``vs_mxu`` when band transforms apply (and ``vs_mxu_1pass``, the
        single-pass bf16 passes' bound, for runs under
        ``mxu_precision="bf16"``)."""
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
            out["vs_mxu_1pass"] = ((m["mxu_time_s_bf16"]
                                    + m["vpu_rest_time_s"])
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
                                     mxu_bf16_flops_per_cell,
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
        fpc_bf16 = mxu_bf16_flops_per_cell(dict(zip(pkeys, parrs)), tkeys)
        vpu_rest = vpu_rest_narrow = 0.0
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
            if is_narrow(kspec.dtype):   # banded stages are float32
                vpu_rest_narrow += _stage_ops(kspec)
        n = p.total_elements
        self._mxu_model = {
            "stages": sorted(plans),
            "mxu_flops_per_cell": fpc,
            # unfused (-fmad=false): every flop is an instruction
            "mxu_time_s": fpc * n / self.hw.alu_ops,
            # the opt-in single-pass bf16 passes on tensor cores
            "mxu_flops_per_cell_bf16": fpc_bf16,
            "mxu_time_s_bf16": fpc_bf16 * n / self.hw.bf16_tensor_flops,
            "vpu_rest_ops_per_cell": vpu_rest,
            "vpu_rest_time_s": self._alu_seconds(vpu_rest, vpu_rest_narrow),
        }
        return self._mxu_model

    def roofline_time_s(self, mxu_precision: str = "split",
                        compute_dtype=None) -> float:
        """Runtime lower bound: the memory floor (``hbm_time_s``, at 2
        bytes a cell under a narrow ``compute_dtype``) against the
        faster of the two compute strategies — every stage per cell (a
        narrow stage's ops at the packed rate), or band transforms for
        the eligible stages (single-pass bf16 under
        ``mxu_precision="bf16"``) plus per-cell ops for the rest."""
        return max(self.hbm_time_s(compute_dtype),
                   self._compute(mxu_precision, compute_dtype)[0], 1e-12)

    def bound(self, mxu_precision: str = "split", compute_dtype=None) -> str:
        """"hbm", "alu" (per-cell ops) or "mxu" (band transforms, the JAX
        package's name for that strategy)."""
        compute, _, kind = self._compute(mxu_precision, compute_dtype)
        return kind if compute > self.hbm_time_s(compute_dtype) else "hbm"

    def roofline_gcell_s(self, mxu_precision: str = "split",
                         compute_dtype=None) -> float:
        return (self.program.total_elements
                / self.roofline_time_s(mxu_precision, compute_dtype) / 1e9)

    def fast_memory_bytes(self) -> int:
        """On-chip working set of the streaming schedule (delay + line
        buffers), the reference's fast-memory total."""
        return self.analysis.fast_memory_bytes()

    # -- multi-card scaling model ---------------------------------------------
    def mesh_scaling(self, mesh_dims: Dict[str, int],
                     dim_axes=(None, "x", "y"),
                     ici_bandwidth: float = config.H100_NVLINK_BANDWIDTH
                     ) -> Dict:
        """Analytic scaling of the domain decomposition over a mesh of
        cards: per-card compute (widened by the chain halo) plus the one
        cumulative-halo exchange per chain evaluation
        (``parallel/domain.py``), the exchange at ``ici_bandwidth`` (one
        NVLink direction by default).  ``mesh_dims``: {axis name: cards
        along it}; ``dim_axes``: per padded dim (i, j, k) the mesh axis
        that shards it, or None.  The keys are the JAX package's."""
        from .backend.dense import chain_halo
        dims = self.program.dimensions
        halo = chain_halo(self.analysis)
        used = [a for a in dim_axes if a]
        if len(set(used)) != len(used):
            raise ValueError(f"mesh axis used for two dims: {dim_axes}")
        unknown = [a for a in used if a not in mesh_dims]
        if unknown:
            raise ValueError(f"dim_axes name(s) {unknown} missing from "
                             f"mesh {dict(mesh_dims)}")
        n_dev = int(np.prod(list(mesh_dims.values())))  # unused axes
        local = list(dims)                              # replicate
        shards = [1, 1, 1]
        for d, ax in enumerate(dim_axes):
            m = mesh_dims.get(ax, 1) if ax else 1
            if m <= 1:
                continue
            if dims[d] % m:
                raise ValueError(
                    f"dim {d} ({dims[d]}) not divisible by mesh axis "
                    f"{ax!r} ({m})")
            shards[d] = m
            local[d] = dims[d] // m

        # redundant compute on the exchanged halo shell: the roofline (the
        # memory floor against the faster compute strategy) of the
        # block's widened share of the domain
        widened = 1.0
        for d in range(3):
            if shards[d] > 1:
                widened *= (local[d] + 2 * halo[d]) / local[d]
        frac = np.prod(local) / self.program.total_elements
        t_comp = max(self.roofline_time_s() * frac * widened, 1e-12)

        # cumulative-halo exchange: per sharded dim, both faces, for every
        # input spanning it; dims are exchanged one after another, so a
        # later dim's slab spans the earlier dims widened (corners).  The
        # bytes the port's exchange copies into a position with a
        # neighbour on both faces (tests/test_torch_mesh_model.py).
        ici_bytes = 0
        for name, spec in self.program.inputs.items():
            if spec.is_scalar:
                continue
            isz = np.dtype(self.program.field_dtype(name)).itemsize
            for d in range(3):
                if shards[d] <= 1 or not spec.dim_mask[d] or not halo[d]:
                    continue
                cross = 1
                for o in range(3):
                    if o == d or not spec.dim_mask[o]:
                        continue
                    w = local[o]
                    if o < d and shards[o] > 1 and halo[o]:
                        w += 2 * halo[o]
                    cross *= w
                ici_bytes += 2 * halo[d] * cross * isz
        t_ici = ici_bytes / ici_bandwidth
        t_step = t_comp + t_ici          # no compute/exchange overlap
        t_single = self.roofline_time_s()

        # the comm_overlap body: the interior evaluates the unwidened
        # block while the exchange runs, then per sharded face a 3h strip
        # of the widened block (spanning every other dim widened)
        per_cell = t_comp / (np.prod(local) * widened)
        interior_cells = float(np.prod(local))
        strip_cells = 0.0
        for d in range(3):
            if shards[d] <= 1 or not halo[d]:
                continue
            face = 1.0
            for o in range(3):
                if o == d:
                    continue
                face *= local[o] + (2 * halo[o]
                                    if shards[o] > 1 and halo[o] else 0)
            strip_cells += 2 * 3 * halo[d] * face
        t_int = per_cell * interior_cells
        t_strips = per_cell * strip_cells
        t_step_ov = max(t_int, t_ici) + t_strips
        overlap = {
            "interior_cells": interior_cells,
            "strip_cells": strip_cells,
            "t_interior_s": t_int,
            "t_strips_s": t_strips,
            "t_step_s": t_step_ov,
            "hidden_ici_s": min(t_ici, t_int),
            "exposed_ici_s": max(0.0, t_ici - t_int),
            "parallel_efficiency": t_single / (n_dev * t_step_ov)
            if t_step_ov > 0 else 1.0,
            "scaled_gcell_s":
                self.program.total_elements / t_step_ov / 1e9
                if t_step_ov > 0 else float("inf"),
            "wins": t_step_ov < t_step,
            # the exchange time above which the overlap pays: its
            # overcompute, t_int + t_strips - t_comp
            "break_even_ici_s": max(0.0, t_int + t_strips - t_comp),
        }
        return {
            "devices": n_dev,
            "mesh": dict(mesh_dims),
            "dim_axes": list(dim_axes),
            "local_dims": local,
            "halo": list(halo),
            "ici_bytes_per_device": ici_bytes,
            "t_compute_s": t_comp,
            "t_ici_s": t_ici,
            "t_step_s": t_step,
            "parallel_efficiency": t_single / (n_dev * t_step),
            "scaled_gcell_s":
                self.program.total_elements / t_step / 1e9,
            "comm_overlap": overlap,
        }

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
                f"({eb.total_bytes()} B {dtype_to_str(eb.dtype)})")
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
