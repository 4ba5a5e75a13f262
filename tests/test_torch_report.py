"""The port's analytic report against the JAX package's, on the CPU.

``stencilflow_tpu_torch/report.py`` keeps the JAX package's counts and
changes only what they are divided by (the H100 model of config.py).
With the hardware constants set equal and the port's per-op costs
patched to the reference's, every number of both reports is the same,
exactly: op counts, the critical path and runtime bound, communication
volume, fast-memory and footprint bytes, the memory and ALU times
(``alu_time_s`` against the reference's ``vpu_time_s``), the
out-of-core hint and the band-transform stages.  The ``as_dict`` keys
are the reference's but for the single-pass bf16 prices, which are not
ported.
"""
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu.report as ref_report
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.report as port_report
from stencilflow_tpu_torch import config
from stencilflow_tpu_torch.synthesize import synthesize_stencil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(os.path.join(ROOT, "examples", f)
                  for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith(".json"))
SYNTH = {
    "jacobi3d": dict(num_stages=3, dimensions=(16, 16, 16),
                     shape="diffusion"),
    "jacobi2d": dict(num_stages=4, dimensions=(32, 32), shape="diffusion"),
    "hdiff": dict(num_stages=2, dimensions=(8, 12, 16), shape="hdiff"),
    "hotspot": dict(num_stages=3, dimensions=(12, 12, 12), shape="hotspot"),
    "box-r2": dict(num_stages=4, dimensions=(16, 16, 16), shape="box",
                   extent=2),
    "cross-r2": dict(num_stages=3, dimensions=(16, 16, 16), shape="cross",
                     extent=2),
}
PROGRAMS = sorted(SYNTH) + EXAMPLES


def _spec(name):
    return synthesize_stencil(**SYNTH[name]) if name in SYNTH else name


def _reports(name, monkeypatch, hbm_bytes=None):
    """(reference Report, port Report) on equal hardware constants and
    the reference's per-op costs."""
    monkeypatch.setattr(port_report, "_OP_COST", ref_report._OP_COST)
    spec = _spec(name)
    rh = ref_report.HardwareModel()
    if hbm_bytes is not None:
        rh.hbm_bytes = hbm_bytes
    ph = port_report.HardwareModel(hbm_bandwidth=rh.hbm_bandwidth,
                                   alu_ops=rh.vpu_elemops,
                                   hbm_bytes=rh.hbm_bytes)
    return (ref_report.Report.build(ref.parse_program(spec), hw=rh),
            port_report.Report.build(port.parse_program(spec), hw=ph))


KEYS = ("ops_per_cell", "weighted_ops_per_cell", "total_ops",
        "critical_path_cycles", "runtime_lower_bound_cycles",
        "min_communication_volume_bytes", "fast_memory_bytes",
        "hbm_footprint_bytes", "suggested_host_chunks", "hbm_time_s",
        "vpu_time_s", "dimensions", "kernels", "vectorization")


@pytest.mark.parametrize("name", PROGRAMS,
                         ids=lambda n: os.path.basename(n))
def test_report_matches_reference(name, monkeypatch):
    r, p = _reports(name, monkeypatch)
    dr, dp = r.as_dict(), p.as_dict()
    for key in KEYS:
        assert dr[key] == dp[key], key
    assert p.alu_time_s() == r.vpu_time_s()
    assert set(dr) == set(dp)
    mr, mp = dr["mxu_model"], dp["mxu_model"]
    assert (mr is None) == (mp is None)
    if mr is not None:
        assert mr["stages"] == mp["stages"]
        assert mr["vpu_rest_ops_per_cell"] == mp["vpu_rest_ops_per_cell"]
        assert set(mr) - set(mp) == {"mxu_flops_per_cell_bf16",
                                     "mxu_time_s_bf16"}
        assert set(mp) <= set(mr)
    # the dump after the roofline header is hardware-independent
    tail = "\n\nkernels:"
    assert r.full_dump().split(tail, 1)[1] == p.full_dump().split(tail, 1)[1]


@pytest.mark.parametrize("name,chunks", [("jacobi3d", True),
                                         ("hotspot", True),
                                         ("jacobi2d", False)])
def test_suggested_host_chunks_matches(name, chunks, monkeypatch):
    """Over the device-memory budget the hint is the reference's: the
    smallest power-of-two chunk count that fits (a 2-D program has no i
    extent to chunk), else 0."""
    r, p = _reports(name, monkeypatch)
    total = p.hbm_footprint_bytes()
    assert p.suggested_host_chunks() == 1
    for hbm in (total // 2, total // 5, 64):
        r, p = _reports(name, monkeypatch, hbm_bytes=hbm)
        assert r.suggested_host_chunks() == p.suggested_host_chunks()
        assert "out-of-core advised" in str(p)
    assert p.suggested_host_chunks() == 0            # 64 bytes
    r, p = _reports(name, monkeypatch, hbm_bytes=total // 2)
    assert (p.suggested_host_chunks() > 1) == chunks


def test_h100_model_defaults():
    hw = port_report.HardwareModel()
    assert hw.name == "h100-sxm"
    assert hw.hbm_bandwidth == 3.35e12 and hw.hbm_bytes == 80 * 10**9
    assert hw.alu_ops == 67e12 / 2
    assert hw.copy_floor == config.H100_COPY_FLOOR
    assert hw.alu_issue_rate == config.H100_ALU_ISSUE_RATE
    assert hw.smem_pass_rate == config.H100_SMEM_PASS_RATE
    assert port_report._OP_COST is config.H100_OP_COST
    # the reference's cost keys, each measured or scaled
    assert set(config.H100_OP_COST) == set(ref_report._OP_COST)


@pytest.mark.parametrize("name", ["jacobi3d", "box-r2", "hdiff"])
def test_bound_fractions(name):
    p = port_report.Report.build(port.parse_program(_spec(name)))
    dt = 1e-3
    f = p.bound_fractions(dt)
    vol = p.analysis.minimum_communication_volume()
    hw = p.hw
    assert f["vs_hbm"] == round(vol / hw.hbm_bandwidth / dt, 4)
    assert f["vs_copy_floor"] == round(vol / hw.copy_floor / dt, 4)
    ops = p.executed_ops()
    assert f["vs_alu_issue"] == round(ops / hw.alu_issue_rate / dt, 4)
    assert f["vs_smem_pass"] == round(ops / hw.smem_pass_rate / dt, 4)
    m = p.mxu_model()
    assert ("vs_mxu" in f) == (m is not None)
    if m is None:
        assert ops == p.total_ops()
    else:        # box-r2: the composed transforms replace the stages
        assert ops == (m["mxu_flops_per_cell"] + m["vpu_rest_ops_per_cell"]
                       ) * p.program.total_elements < p.total_ops()
    assert p.roofline_time_s() >= p.hbm_time_s()
    assert p.bound() in ("hbm", "alu", "mxu")


@pytest.mark.parametrize("name", ["box-r2", "cross-r2"])
def test_mxu_model_prices_the_stream_kernel(name):
    """The band transforms are priced as the stream kernel runs them:
    the plan's executed multiply-add flops per cell, one instruction
    each (-fmad=false), at the single-instruction rate."""
    from stencilflow_tpu_torch.backend.stream import plan_stream
    prog = port.parse_program(_spec(name))
    p = port_report.Report.build(prog)
    m = p.mxu_model()
    assert m["mxu_flops_per_cell"] == plan_stream(prog).flops_per_cell()
    assert m["mxu_time_s"] == (m["mxu_flops_per_cell"] * prog.total_elements
                               / p.hw.alu_ops)
    assert "mxu_time_s_bf16" not in m


def test_report_text():
    p = port_report.Report.build(port.parse_program(_spec("hdiff")))
    text = str(p)
    assert "roofline [h100-sxm]" in text and "ALU" in text
    dump = p.full_dump()
    assert "optimizer demo" in dump and "relative:" in dump
    assert np.isfinite(p.roofline_gcell_s())
