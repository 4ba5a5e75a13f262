"""The overlap streamer's (K2) schedule on the CPU.

The generated CUDA source also compiles with g++ (``sf_host_launch``: one
thread runs each block over shared memory filled with NaN, refilled
before every block; the ``cp.async`` loads are copies at the point of
issue, their waits do nothing).  That build runs the kernel's own
schedule and must equal its plain version (``overlap_plain``) and the
numpy oracle bit for bit (np.array_equal: no transcendental in these
programs): a block loads the window of each streamed input (its B
output planes and need_lo + need_hi more, widened in j and k), then
evaluates every stage over its i-overlapped region, in a mask-free or a
masked body, R adjacent j cells a thread with i-neighbours from a
register window.  Fixtures cover the constant, copy and shrink boundary
conditions, two streamed inputs and scalars, several blocks along i with
a ragged last one, the I = 1 regime, i-offsets of 3, an int32 and a
float64 program and partial-rank inputs.  Three deliberately wrong
schedules (every block mask-free, a window one plane short, a window
without its need_lo planes) show as mismatches.
"""
import re

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import choose_backend, codegen, overlap
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil
from test_torch_group import jacobi3d, multi_out, wide_i
from test_torch_overlap import PROGRAMS as OVERLAP_PROGRAMS
from test_torch_overlap import _example
from test_torch_stream import run_source


def _synth(shape, dims, iters, **kw):
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0,1", **kw)


def _fuzz(seed, **kw):
    return lambda: random_program(np.random.default_rng(seed), **kw)


# name: (program maker, plan options)
K2 = {
    "jacobi3d-constant-skeleton": (
        lambda: _synth("diffusion", (24, 20, 36), 2, boundary_value=0.5),
        dict(tile=(2, 4, 8), R=1, window=False)),
    "jacobi3d-constant-R4": (
        lambda: _synth("diffusion", (24, 20, 36), 2, boundary_value=0.5),
        dict(tile=(2, 4, 8), R=4, window=True)),
    "jacobi3d-constant-R1-window": (
        lambda: _synth("diffusion", (24, 20, 36), 2, boundary_value=0.5),
        dict(tile=(2, 4, 8), R=1, window=True)),
    "jacobi3d-copy-R2": (
        lambda: _synth("diffusion", (20, 20, 36), 2, boundary="copy"),
        dict(tile=(4, 4, 8), R=2, window=True)),
    "jacobi3d-copy-R2-ragged": (
        lambda: _synth("diffusion", (18, 21, 36), 2, boundary="copy"),
        dict(tile=(4, 8, 8), R=2, window=True)),
    "jacobi3d-shrink-R4-ragged": (
        lambda: _synth("diffusion", (18, 20, 36), 2, boundary="shrink"),
        dict(tile=(4, 4, 16), R=4, window=True)),
    "hotspot3d-R4": (lambda: _synth("hotspot", (12, 18, 30), 2),
                     dict(tile=(2, 4, 8), R=4, window=True)),
    "hotspot3d-R2-no-window": (lambda: _synth("hotspot", (12, 18, 30), 2),
                               dict(tile=(4, 8, 8), R=2, window=False)),
    "hotspot3d-R1-window": (lambda: _synth("hotspot", (12, 18, 30), 2),
                            dict(tile=(2, 4, 8), R=1, window=True)),
    "jacobi2d-I1-R4": (lambda: _synth("diffusion", (40, 72), 3),
                       dict(R=4, window=True)),
    "jacobi2d-I1-skeleton": (lambda: _synth("diffusion", (40, 72), 2),
                             dict(R=1, window=False)),
    "wide-i-R2": (wide_i, dict(tile=(2, 4, 8), R=2, window=True)),
    "hdiff-R2": (lambda: _example("hdiff_64x64x64.json", 12),
                 dict(tile=(2, 4, 8), R=2, window=True)),
    "fuzz122-partial-rank": (_fuzz(122), dict(R=2, window=True)),
    "fuzz-i32-R4": (_fuzz(6, ndim=3, data_type="int32",
                          data="random:-20,20"),
                    dict(tile=(2, 4, 8), R=4, window=True)),
    "fuzz-i32-R2-no-window": (_fuzz(6, ndim=3, data_type="int32",
                                    data="random:-20,20"),
                              dict(tile=(2, 4, 8), R=2, window=False)),
    "fuzz-f64-shrink": (_fuzz(5, ndim=3, data_type="float64",
                              bc_kinds=("constant", "copy", "shrink")),
                        dict(tile=(2, 4, 8), R=1, window=True)),
}


def _k2(name):
    make, kw = K2[name]
    p = port.parse_program(make())
    an = port.ChainAnalysis.run(p)
    return p, an, overlap.OverlapPlan.build(an, **kw)


def _twin(p, an, plan, tmp_path, seed=3, source=None):
    """(g++ build of the kernel, plain version, oracle) outputs; ``source``
    replaces the generated kernel."""
    inputs = port.load_input_arrays(p, seed=seed)
    want = overlap.overlap_plain(p, an, plan, spanned_arrays(p, inputs))
    got = run_source(source or codegen.overlap_source(p, an, plan), p,
                     inputs, [], tmp_path)
    oracle = port.run_interpreter(p, inputs)
    return got, {o: v.numpy() for o, v in want.items()}, oracle


def _differs(got, want):
    return not all(np.array_equal(got[o], want[o], equal_nan=True)
                   for o in want)


@pytest.mark.parametrize("name", sorted(K2))
def test_overlap_twin_matches_plain_and_oracle(name, tmp_path):
    p, an, plan = _k2(name)
    got, want, oracle = _twin(p, an, plan, tmp_path)
    for o in oracle:
        assert got[o].dtype == oracle[o].dtype
        np.testing.assert_array_equal(got[o], want[o])
        np.testing.assert_array_equal(got[o].reshape(oracle[o].shape),
                                      oracle[o])


def test_fixtures_cover_blocks_along_i_and_both_bodies():
    """Several blocks along i, columns and blocks of both bodies, a last
    block past I, and I = 1."""
    p, _, plan = _k2("jacobi3d-constant-R4")
    n_i, ntj, ntk = plan.grid(p.dimensions)
    assert n_i == 12 and plan.region("a")[0] == 2 + 4
    assert 0 < plan.inner_blocks(p) < ntj * ntk
    for s in p.kernels:
        tlo, thi = plan.free_steps(p, s)
        assert 0 < tlo < thi < n_i, (s, tlo, thi)
    r, _, ragged = _k2("jacobi3d-shrink-R4-ragged")
    assert r.dimensions[0] % ragged.tile[0]
    t, _, flat = _k2("jacobi2d-I1-R4")
    assert t.dimensions[0] == 1 and flat.grid(t.dimensions)[0] == 1
    assert flat.R == 4


def _body(src):
    """The block body from the input windows' loads on (after the
    divisions that give a thread its first positions)."""
    body = src[src.index("SF_DEV void sf_overlap_block"):
               src.index("#ifdef __CUDACC__\n__global__")]
    first = "// the block's input windows" if "// the block's input " \
        "windows" in body else "// stage"
    return body[:body.index(first)], body[body.index(first):]


@pytest.mark.parametrize("name", ["jacobi3d-constant-skeleton",
                                  "jacobi3d-constant-R4",
                                  "jacobi3d-copy-R2-ragged",
                                  "hotspot3d-R4", "fuzz122-partial-rank",
                                  "jacobi2d-I1-R4"])
def test_reads_and_passes_have_no_modulo_or_division(name):
    """Every shared-memory read is one load at a constant offset from a
    per-position pointer; the loads and passes have no % or / but the
    position loops' constant strides (SF_NT % n, SF_NT / n)."""
    p, an, plan = _k2(name)
    _pre, body = _body(codegen.overlap_source(p, an, plan))
    reads = re.findall(r"\bq_\w+\[[^\]]*\]", body)
    assert reads
    for r in reads:
        assert re.fullmatch(r"q_\w+\[-?\d+\]", r), r
    ops = re.findall(r"\S+\s*[%/]\s*\S+", body.replace("//", "#"))
    for op in ops:
        assert op.startswith("SF_NT"), op


def test_inputs_load_by_async_copies_before_the_first_stage():
    """The block issues its window of both inputs by ``cp.async``, from
    need_lo planes before its first output plane, and waits for it before
    the first stage; no stage reads an input from device memory, and
    there is one barrier a stage."""
    p, an, plan = _k2("hotspot3d-R4")
    _pre, body = _body(codegen.overlap_source(p, an, plan))
    first_stage = body.index("// stage")
    top = body[:first_stage]
    for f in ("a", "power"):
        assert f"sf_cp4(d, g_{f}" in top
        assert f"t * 2 - {plan.needs[f][0][0]} + il" in top
        assert f"g_{f}" not in body[first_stage:]
    assert top.index("SF_CP_WAIT_ALL();") > top.index("sf_cp4(d, g_power")
    assert body.count("SF_SYNC();") == len(p.kernels)


def test_input_rows_load_by_16_byte_copies():
    """Where K is a multiple of a 16-byte copy's elements, an input's rows
    start at an aligned column (need_lo in k rounded up: ``korigin``) and
    load by 16-byte copies (``sf_cp16``); elsewhere one element a copy."""
    p, an, plan = _k2("jacobi3d-constant-R4")
    assert plan.vec == {"a": 4} and plan.korigin("a") == 4
    assert plan.row("a") % 4 == 0 and plan.row("a") >= 4 + 8 + 2
    src = codegen.overlap_source(p, an, plan)
    assert "sf_cp16(d, g_a" in src and "sf_cp4(d, g_a" not in src
    q, qan, qplan = _k2("hotspot3d-R4")
    assert q.dimensions[2] % 4 and qplan.vec == {}
    assert qplan.korigin("a") == qplan.needs["a"][2][0]
    _, _, fplan = _k2("fuzz-f64-shrink")
    assert fplan.vec == {"a": 2}


def test_walk_reuses_registers():
    """R = 4 with the window: jacobi's 6-point stage loads 14 values a
    plane for its 4 cells (3.5 a cell: the i-neighbours from registers,
    the j neighbours shared), against 6 a cell without either; a warp's
    reads stay on consecutive k."""
    p = port.parse_program(_synth("diffusion", (16, 16, 16), 2))
    an = port.ChainAnalysis.run(p)
    plan = overlap.OverlapPlan.build(an, R=4, window=True)
    assert plan.loads(p, "s1") == 14
    keys = overlap.walk_keys(p, "s1", plan.onchip, 4)
    assert keys["s0", 2, 0] == (-1, 1) and keys["s0", -1, 0] == (0, 0)
    skeleton = overlap.OverlapPlan.build(an, R=1, window=False)
    assert skeleton.loads(p, "s1") == 6
    src = codegen.overlap_source(p, an, plan)
    assert "w_s0_0_0_2 = q_s0[" in src and "w_s0_0_0_0 = w_s0_0_0_1;" in src
    assert plan.positions("s1") == (-(-plan.region("s1")[1] // 4),
                                    plan.region("s1")[2])
    assert plan.plane("s0") == (plan.region("s0")[1] + 3) * plan.row("s0")


def test_plan_is_priced_over_tile_threads_and_runs():
    """``OverlapPlan.build`` takes the (B, tj, tk) x threads x runs (R,
    window) of least ``seconds``; forcing any of them gives the plan the
    rule prices."""
    p = port.parse_program(_synth("diffusion", (64, 64, 64), 2))
    an = port.ChainAnalysis.run(p)
    pick = overlap.OverlapPlan.build(an)
    forced = []
    for t in [(B, tj, tk) for B in (1, 2, 4, 8, 16) for tj in (4, 8, 16)
              for tk in (16, 32, 64)]:
        for n in overlap.PANEL_THREADS:
            for r, w in overlap.RUNS:
                try:
                    plan = overlap.OverlapPlan.build(an, t, n, r, w)
                except ValueError:
                    continue   # shared memory
                assert (plan.tile, plan.threads, plan.R, plan.window) == \
                    (t, n, r, w)
                forced.append(plan.seconds(p))
    assert len(forced) > 300 and pick.seconds(p) <= min(forced)
    cands = list(overlap.OverlapPlan.empty(an).candidates(p))
    assert {c[1][0] for c in cands} >= {1, 2, 4, 8, 16, 32}
    assert {c[2] for c in cands} == set(overlap.PANEL_THREADS)
    assert {c[3:5] for c in cands} == set(overlap.RUNS)
    assert min(cands)[0][0] == pick.seconds(p)
    assert pick.smem_bytes(p) <= overlap.H100_SMEM_PER_BLOCK
    two = overlap.OverlapPlan.build(an, (4, 16, 32), 256, 1, False)
    assert two.blocks(p.dimensions) == 16 * 4 * 2


def test_every_block_mask_free_shows(tmp_path, monkeypatch):
    """Taking the mask-free body in boundary columns and blocks breaks
    the result."""
    p, an, plan = _k2("jacobi3d-constant-R4")
    monkeypatch.setattr(plan, "reach", lambda program: (0, 0, 0, 0))
    monkeypatch.setattr(plan, "free_steps", lambda program, s: (0, 10 ** 6))
    got, want, _ = _twin(p, an, plan, tmp_path)
    assert _differs(got, want)


def test_window_one_plane_short_shows(tmp_path):
    """A window that leaves out its last plane (the need_hi side): the
    stages read a plane that was never loaded."""
    p, an, plan = _k2("jacobi3d-constant-R4")
    RI, RJ, _ = plan.region("a")
    NC = plan.row("a") // plan.vec["a"]
    src = codegen.overlap_source(p, an, plan)
    loop = f"p < {RI * RJ * NC}; p += SF_NT"
    assert src.count(loop) == 1
    got, want, _ = _twin(p, an, plan, tmp_path, source=src.replace(
        loop, f"p < {(RI - 1) * RJ * NC}; p += SF_NT"))
    assert _differs(got, want)


def test_window_without_its_need_lo_planes_shows(tmp_path):
    """A window loaded from the block's own first output plane reads
    need_lo planes it never loaded, and misplaces the rest."""
    p, an, plan = _k2("jacobi3d-constant-R4")
    lo = plan.needs["a"][0][0]
    assert lo == 2
    src = codegen.overlap_source(p, an, plan)
    first = f"gi = t * 2 - {lo} + il"
    assert src.count(first) == 1
    got, want, _ = _twin(p, an, plan, tmp_path,
                         source=src.replace(first, "gi = t * 2 + il"))
    assert _differs(got, want)


# every fixture of this file and of tests/test_torch_overlap.py, and the
# cells of chip_smoke.py: (the lowering choose_backend took, whether the
# overlap planner accepted it) on the tree before the redesign
ROUTED = {
    "jacobi3d-512x2": ((lambda: _synth("diffusion", (512,) * 3, 2)),
                       ("overlap", True)),
    "hotspot3d-512x2": ((lambda: _synth("hotspot", (512,) * 3, 2)),
                        ("overlap", True)),
    "jacobi2d-8192x2": ((lambda: _synth("diffusion", (8192, 8192), 2)),
                        ("overlap", True)),
    "jacobi2d-8192x3": ((lambda: _synth("diffusion", (8192, 8192), 3)),
                        ("overlap", True)),
    "jacobi3d-512x8": ((lambda: _synth("diffusion", (512,) * 3, 8)),
                       ("panel", True)),
    "hdiff3d-256x8": ((lambda: _synth("hdiff", (256,) * 3, 8)),
                      ("panel", True)),
    "hotspot3d-256x8": ((lambda: _synth("hotspot", (256,) * 3, 8)),
                        ("panel", True)),
    "box3d-256x8-r2": ((lambda: _synth("box", (256,) * 3, 8, extent=2)),
                       ("stream", False)),
    "cross-64x4-r12": ((lambda: _synth("cross", (64,) * 3, 4, extent=12)),
                       ("dense", False)),
    "jacobi2d-8192x8": ((lambda: _synth("diffusion", (8192, 8192), 8)),
                        ("rows+group_g8", True)),
    "hdiff2d-8192x16": ((lambda: _synth("hdiff", (8192, 8192), 16)),
                        ("panel", False)),
    "jacobi3d-copy-16x4": ((lambda: jacobi3d(16, 4, "copy")),
                           ("panel", True)),
    "multi_out": (multi_out, ("panel", True)),
    "jacobi3d-40x48x72x2": ((lambda: _synth("diffusion", (40, 48, 72), 2)),
                            ("overlap", True)),
    "box-r2-40x48x72x4": ((lambda: _synth("box", (40, 48, 72), 4,
                                          extent=2)), ("stream", True)),
    "hdiff3d-2x8": ((lambda: _synth("hdiff", (8, 12, 16), 2)),
                    ("panel", True)),
    "fuzz905": (_fuzz(905), ("panel", True)),
    "overlap-jacobi3d": (OVERLAP_PROGRAMS["jacobi3d"], ("panel", True)),
    "overlap-hdiff": (OVERLAP_PROGRAMS["hdiff"], ("overlap", True)),
    "overlap-forked_box": (OVERLAP_PROGRAMS["forked_box"],
                           ("overlap", True)),
    "overlap-hotspot": (OVERLAP_PROGRAMS["hotspot"], ("panel", True)),
    "overlap-fuzz100": (OVERLAP_PROGRAMS["fuzz100"], ("overlap", True)),
    "overlap-fuzz101": (OVERLAP_PROGRAMS["fuzz101"], ("overlap", True)),
    "overlap-fuzz122": (OVERLAP_PROGRAMS["fuzz122"], ("panel", True)),
    "overlap-fuzz127": (OVERLAP_PROGRAMS["fuzz127"], ("panel", True)),
    "overlap-fuzz132": (OVERLAP_PROGRAMS["fuzz132"], ("panel", True)),
    "wide-i": (wide_i, ("panel", True)),
    "fuzz-i32": (K2["fuzz-i32-R4"][0], ("panel", True)),
    "fuzz-f64-shrink": (K2["fuzz-f64-shrink"][0], ("panel", True)),
    "fuzz6": (_fuzz(6), ("overlap", True)),
}


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_routes_and_acceptance_unchanged(name):
    """Every fixture the planner accepted before the redesign is accepted,
    the ones it refused are refused, and choose_backend routes each as it
    did."""
    make, (route, accepted) = ROUTED[name]
    p = port.parse_program(make())
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda") == route
    try:
        overlap.OverlapPlan.build(an)
        got = True
    except ValueError:
        got = False
    assert got == accepted
