"""The group kernel's (K5) and the overlapped-tile kernel's (K6) schedules
on the CPU.

The generated CUDA sources also compile with g++ (``sf_host_launch``: one
thread runs each block over shared memory filled with NaN, refilled
before every block of a segmented grid; the ``cp.async`` loads are
copies at the point of issue, their waits do nothing).  That build runs
each kernel's own schedule and must equal its plain version and the
numpy oracle bit for bit (np.array_equal: no transcendental in these
programs).

* K5 (``codegen.group_source``): ring slots from per-step counters, the
  rings' shifted planes and mirrored wrap planes, input panels loaded a
  panel ahead (at the step's top into an extra slot, or after the last
  reader of the slot they take), the mask-free or masked stage body per
  block and panel, and i-segments with their warm-up.  Whole, with
  segments, with both bodies exercised, on the constant, copy and shrink
  boundary conditions; no ``%`` or ``/`` in a ring read or a pass; three
  deliberately wrong schedules (every block mask-free, no warm-up before
  a segment, no slot for the panel in flight) show as mismatches.
* K6 (``codegen.tile_source``): masked and fast on jacobi and hdiff, fast
  (one launch, mask-free interior blocks and masked border blocks, no
  fix-up) equal to masked bit for bit.
"""
import re

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import codegen, group, tile
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil
from test_torch_group import jacobi3d, wide_i
from test_torch_stream import run_source
from test_torch_tile import _example


def _synth(shape, dims, iters, **kw):
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0,1", **kw)


def _rows(shape, dims, iters, **kw):
    return lambda: (port.parse_program(_synth(shape, dims, iters, **kw)),
                    True)


def _plain3d(make):
    return lambda: (port.parse_program(make()), False)


def last_reads_input():
    """The last stage reads the input one plane back: the panel the next
    one replaces is read until the step's end (an extra slot)."""
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [16, 8, 12],
        "program": {
            "m": {"computation_string": "m = a[i-1,j,k] + 0.5*a[i+1,j,k-1]",
                  "boundary_conditions": {
                      "a": {"type": "constant", "value": 0.5}},
                  "data_type": "float32"},
            "y": {"computation_string":
                  "y = m[i-1,j,k] + m[i+1,j+1,k] - 0.25*a[i-1,j,k]",
                  "boundary_conditions": {
                      "m": {"type": "copy"},
                      "a": {"type": "constant", "value": 0.5}},
                  "data_type": "float32"}}}


# name: (program maker -> (program, rotate to rows), B, g, tile, segments)
# -- one per BC kind, segments of a one-group and a many-group chain,
# static and scalar inputs, two streamed inputs, i-offsets wider than B
K5 = {
    "jacobi2d-constant": (_rows("diffusion", (96, 56), 8,
                                boundary_value=0.5), 16, 8, (1, 16), 1),
    "jacobi2d-constant-S3": (_rows("diffusion", (96, 56), 8,
                                   boundary_value=0.5), 16, 8, (1, 16), 3),
    "jacobi2d-copy-S2": (_rows("diffusion", (96, 56), 8, boundary="copy"),
                         16, 8, (1, 16), 2),
    "jacobi2d-shrink-S6": (_rows("diffusion", (96, 56), 8,
                                 boundary="shrink"), 16, 8, (1, 16), 6),
    "hotspot2d-S2": (_rows("hotspot", (64, 48), 8), 16, 8, (1, 16), 2),
    "jacobi3d-g2-S4": (_plain3d(lambda: jacobi3d(16, 8, "copy")), 2, 2,
                       (4, 8), 4),
    "jacobi3d-g3-S3": (_plain3d(lambda: jacobi3d(12, 6, "shrink")), 2, 3,
                       (4, 8), 3),
    "wide-i-S3": (_plain3d(wide_i), 2, 2, (2, 8), 3),
    "last-reads-input-S3": (_plain3d(last_reads_input), 2, 2, (2, 8), 3),
    "fuzz122-S2": (_plain3d(lambda: random_program(
        np.random.default_rng(122))), 0, 2, None, 2),
    "fuzz905": (_plain3d(lambda: random_program(
        np.random.default_rng(905))), 0, 2, None, 1),
}


def _k5(name, **kw):
    make, B, g, tile_, S = K5[name]
    p0, rows = make()
    p = rotate_2d_to_rows(p0) if rows else p0
    an = port.ChainAnalysis.run(p)
    if not B:
        B = 2 if p.dimensions[0] % 2 == 0 else 1
    plan = group.plan_group(p, an, B, g, tile_, segments=min(
        S, p.dimensions[0] // B), **kw)
    return p0, p, an, plan


def _twin(p0, p, an, plan, tmp_path, seed=3):
    """(g++ build of the kernel, plain version, oracle) outputs."""
    inputs = port.load_input_arrays(p0, seed=seed)
    got = run_source(codegen.group_source(p, an, plan), p, inputs, [],
                     tmp_path)
    want = group.group_plain(p, an, plan, spanned_arrays(p, inputs))
    oracle = port.run_interpreter(p0, inputs)
    return got, {o: v.numpy() for o, v in want.items()}, oracle


def _equal(got, want, oracle):
    for o in oracle:
        g = got[o]
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, want[o])
        np.testing.assert_array_equal(g.reshape(oracle[o].shape), oracle[o])


def _differs(got, want):
    return not all(np.array_equal(got[o], want[o], equal_nan=True)
                   for o in want)


@pytest.mark.parametrize("name", sorted(K5))
def test_group_twin_matches_plain_and_oracle(name, tmp_path):
    p0, p, an, plan = _k5(name)
    assert plan.segments == K5[name][4] or p.dimensions[0] // plan.B < \
        K5[name][4]
    _equal(*_twin(p0, p, an, plan, tmp_path))


def test_fixtures_cover_segments_and_both_bodies():
    """The fixtures cut I into several segments, with warm-up panels
    before them (a many-group chain warms up more than one panel); the
    rows fixtures have interior and boundary tiles and panels of both
    kinds; hotspot2d's `power` (read by every stage) issues its next panel
    after its oldest panel's last reader, before the last stage."""
    p0, p, an, plan = _k5("jacobi2d-constant-S3")
    ntj, ntk = plan.grid(p.dimensions)
    assert plan.segments == 3 and 0 < plan.inner_blocks(p) < ntj * ntk
    n = p.dimensions[0] // plan.B
    for g in range(len(plan.groups)):
        for s in plan.live(g):
            qlo, qhi = plan.free_panels(p, g, s)
            assert 0 < qlo < qhi < n, (s, qlo, qhi)
    assert plan.warmup(p)["steps"] >= 1
    _, q, _, deep = _k5("jacobi3d-g2-S4")
    w = deep.warmup(q)
    assert len(deep.groups) == 4 and w["steps"] >= 2
    assert max(lo for lo, _ in w["group"].values()) >= 2
    _, h, _, hot = _k5("hotspot2d-S2")
    assert hot.issue["power"] == len(hot.phases()) - 2
    assert hot.slots("power") == hot.depth["power"]


def _march(src):
    """The block body's step loop (everything after the thread origins
    and the prologue)."""
    body = src[src.index("SF_DEV void sf_group_block"):
               src.index("#ifdef __CUDACC__\n__global__")]
    return body, body[body.index("for (int t = T0;"):]


@pytest.mark.parametrize("name", ["jacobi2d-constant-S3", "hotspot2d-S2",
                                  "jacobi3d-g2-S4", "fuzz122-S2"])
def test_ring_reads_and_passes_have_no_modulo(name):
    """Every ring read is a per-step base (set once a step per group and
    ring) plus the thread's cell and a constant; the march has no % or /
    but the region loops' constant strides (SF_NT % n, SF_NT / n)."""
    _, p, an, plan = _k5(name)
    body, march = _march(codegen.group_source(p, an, plan))
    reads = re.findall(r"\brb\d+_\w+\[[^\]]*\]", march)
    assert reads
    for r in reads:
        assert re.fullmatch(r"rb\d+_\w+\[(p|x\d+_\d+) \+ -?\d+\]", r), r
    for r in re.findall(r"\bb_\w+\[[^\]]*\]", march):
        assert re.fullmatch(r"b_\w+\[(p|x\d+_\d+)( \+ -?\d+)?\]", r), r
    ops = re.findall(r"\S+\s*[%/]\s*\S+", march.replace("//", "#"))
    for op in ops:
        assert re.fullmatch(r"(\(?SF_NT [%/] \d+( % \d+)?;?)", op) or \
            op.startswith("SF_NT"), op
    # every ring base is a counter slot and a constant, no modulo
    for base in re.findall(r"rb\d+_\w+ = ([^;]*);", march):
        assert "%" not in base and "/" not in base, base


def test_inputs_load_a_panel_ahead():
    """The panel in flight: a prologue issues panel T0 and waits for it
    before the march; step t issues panel t + 1 — right after the last
    reader of the slot it takes, or at its top into the extra slot (a
    ring whose replaced panel the last stage reads) — and every thread
    waits for its copies before the step's last barrier, the only one
    after the last stage: 8 barriers a step for 8 stages."""
    _, p, an, plan = _k5("hotspot2d-S2")
    src = codegen.group_source(p, an, plan)
    body, march = _march(src)
    pro = body[:body.index("for (int t = T0;")]
    assert "sf_cp4(d, g_a" in pro and "sf_cp4(d, g_power" in pro
    assert pro.index("SF_CP_WAIT_ALL();") > pro.index("sf_cp4(d, g_power")
    assert march.count("SF_SYNC();") == 8 and \
        march.count("SF_CP_WAIT_ALL();") == 1
    wait = march.index("SF_CP_WAIT_ALL();")
    assert wait > march.index("// stage s7") and \
        march.index("SF_SYNC();", wait) < march.index("m3 = sf_wrap")
    # `a` (read by the first stage only) after stage s0, into its slot
    assert "g_a" not in march[:march.index("// stage s0")]
    after0 = march[march.index("// stage s0"):march.index("// stage s1")]
    assert "the last reader is done" in after0 and "(t + 1) * 16" in after0
    # `power` after stage s6, before s7
    s7 = march.index("// stage s7")
    assert "g_power" in march[march.index("// stage s6"):s7]
    assert "g_power" not in march[s7:]
    assert plan.slots("a") == plan.depth["a"]
    # an input whose replaced panel the last stage reads takes the extra
    # slot at the step's top
    _, q, qan, qplan = _k5("last-reads-input-S3")
    _, qmarch = _march(codegen.group_source(q, qan, qplan))
    assert qplan.issue["a"] is None
    assert qplan.slots("a") == qplan.depth["a"] + 1
    assert qmarch.index("g_a") < qmarch.index("// stage")


def test_plan_is_priced_over_tiles_threads_and_segments():
    """``plan_group`` takes the (tile, threads, segments) of least
    ``GroupPlan.seconds``; forcing any of them gives the plan the rule
    prices, and segments must lie in [1, I/B]."""
    p = rotate_2d_to_rows(port.parse_program(_synth("diffusion",
                                                    (8192, 8192), 8)))
    an = port.ChainAnalysis.run(p)
    pick = group.plan_group(p, an, 64, 8)
    best = min(
        (group.plan_group(p, an, 64, 8, t, n, S).seconds(p), t, n, S)
        for t in ((1, 8), (1, 16), (1, 32), (1, 64), (1, 128))
        for n in (256, 512) for S in group.SEGMENTS)
    assert pick.seconds(p) == best[0]
    assert (pick.tile, pick.threads, pick.segments) == best[1:]
    assert pick.smem_bytes(p) <= group.H100_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="segments"):
        group.plan_group(p, an, 64, 8, segments=129)
    two = group.plan_group(p, an, 64, 8, (1, 32), 256, 2)
    assert two.blocks(p) == 2 * 256 and two.steps(p) == 64 + 1 + 1


def test_every_block_mask_free_shows(tmp_path, monkeypatch):
    """Taking the mask-free body in boundary tiles and panels breaks the
    result."""
    p0, p, an, plan = _k5("jacobi2d-constant-S3")
    monkeypatch.setattr(plan, "reach", lambda program: (0, 0))
    monkeypatch.setattr(plan, "free_panels",
                        lambda program, g, s: (0, 10 ** 6))
    got, want, _ = _twin(p0, p, an, plan, tmp_path)
    assert _differs(got, want)


def test_no_warmup_before_a_segment_shows(tmp_path, monkeypatch):
    """A segment that starts at its own first panel reads rings no step
    filled."""
    p0, p, an, plan = _k5("jacobi3d-g2-S4")
    w = plan.warmup(p)
    monkeypatch.setattr(plan, "warmup", lambda program: {
        "group": {g: (0, hi) for g, (_lo, hi) in w["group"].items()},
        "steps": 0, "in_hi": w["in_hi"]})
    got, want, _ = _twin(p0, p, an, plan, tmp_path)
    assert _differs(got, want)


def test_no_slot_for_the_panel_in_flight_shows(tmp_path, monkeypatch):
    """Loading panel t + 1 at the step's top into a ring without its extra
    slot overwrites a panel the step still reads."""
    p0, p, an, plan = _k5("last-reads-input-S3")
    assert plan.issue["a"] is None
    monkeypatch.setattr(plan, "slots", lambda f: plan.depth[f])
    got, want, _ = _twin(p0, p, an, plan, tmp_path)
    assert _differs(got, want)


# -- K6 ----------------------------------------------------------------------

K6 = {
    "jacobi3d": (lambda: _synth("diffusion", (12, 24, 40), 2), (2, 4, 8)),
    "jacobi3d-copy": (lambda: _synth("diffusion", (12, 20, 36), 2,
                                     boundary="copy"), (2, 4, 8)),
    "hdiff": (lambda: _example("hdiff_64x64x64.json", 28), (1, 4, 8)),
    "hdiff-shrink": (lambda: _synth("hdiff", (4, 24, 40), 2,
                                    boundary="shrink"), (1, 4, 8)),
}


@pytest.mark.parametrize("name", sorted(K6))
def test_tile_fast_equals_masked_and_oracle(name, tmp_path):
    """Fast mode, one launch with no fix-up, equals masked mode, the plain
    versions of both and the oracle bit for bit; both bodies run."""
    make, t = K6[name]
    p = port.parse_program(make())
    inputs = port.load_input_arrays(p, seed=3)
    oracle = port.run_interpreter(p, inputs)
    got = {}
    for mode in ("masked", "fast"):
        plan = tile.plan_tile(p, tile=t, mode=mode)
        src = tile.tile_source(plan)
        assert ("// mask-free" in src) == (mode == "fast")
        got[mode] = run_source(src, p, inputs, [], tmp_path)
        want = tile.tile_plain(plan, spanned_arrays(p, inputs))
        _equal(got[mode], {o: v.numpy() for o, v in want.items()}, oracle)
    for o in p.outputs:
        np.testing.assert_array_equal(got["fast"][o], got["masked"][o])
    plan = tile.plan_tile(p, tile=t, mode="fast")
    H, dims = plan.halo, p.dimensions
    inner = [sum(1 for b in range(n) if b * tt >= h and b * tt + tt + h <= d)
             for n, tt, h, d in zip(plan.grid(), t, H, dims)]
    assert 0 < np.prod(inner) < np.prod(plan.grid())


def test_tile_fast_mask_free_everywhere_shows(tmp_path):
    """The reference's fast body alone (mask-free in every block, no
    fix-up) differs from the oracle on the border shell: the masked
    border blocks are what make fast mode exact.  (The tile divides the
    domain: a mask-free body writes its whole core.)"""
    make, t = K6["jacobi3d"]
    p = port.parse_program(make())
    plan = tile.plan_tile(p, tile=t, mode="fast")
    src = tile.tile_source(plan).replace("const bool inner = ",
                                         "const bool inner = true || ")
    inputs = port.load_input_arrays(p, seed=3)
    got = run_source(src, p, inputs, [], tmp_path)
    oracle = port.run_interpreter(p, inputs)
    assert _differs({o: got[o].reshape(oracle[o].shape) for o in oracle},
                    oracle)


def test_tile_loops_have_no_division():
    """K6's region loops: a thread's first (il, jl, kl) from divisions
    before the stages, constant strides after; inputs by cp.async."""
    p = port.parse_program(K6["hdiff"][0]())
    src = tile.tile_source(tile.plan_tile(p, tile=K6["hdiff"][1],
                                          mode="fast"))
    body = src[src.index("SF_DEV void sf_tile_block"):
               src.index("#ifdef __CUDACC__\n__global__")]
    loops = body[body.index("#pragma unroll 1"):]
    for op in re.findall(r"\S+\s*[%/]\s*\S+", loops.replace("//", "#")):
        assert op.startswith("SF_NT"), op
    assert "sf_cp4(b_" in body and "SF_CP_WAIT_ALL();" in body
