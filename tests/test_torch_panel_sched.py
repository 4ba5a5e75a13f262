"""The panel kernel's schedule (K1, ``codegen.panel_source``) on the CPU.

The generated CUDA source also compiles with g++ (``sf_host_launch``: one
thread runs each block, over shared memory filled with NaN; the
``cp.async`` loads of the input planes are copies at the point of issue,
their waits do nothing).  That build runs the kernel's own schedule —
ring slots from per-step counters, rings of one step packed by
liveness, the mask-free or masked stage body per block and step, input
planes loaded a step ahead into their extra slots — and must equal the
plain version (``panel_plain``) and the numpy oracle bit for bit
(np.array_equal: no transcendental in these programs).  The port's
plain version is held to the JAX package's panel kernel (interpret mode)
within VERIFY_RTOL by tests/test_torch_panel.py; the CUDA build is held
to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.  Three deliberately wrong schedules (every block
mask-free, every packed ring at one offset, no slot for the plane in
flight) must show as mismatches here.
"""
import os
import re

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import codegen, panel
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.config import H100_SMEM_PER_BLOCK
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.frontend.sdfg_import import sdfg_to_program
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil
from test_torch_panel import PROGRAMS
from test_torch_stream import run_source


def _synth(shape, dims, iters, **kw):
    return lambda: synthesize_stencil(num_stages=iters, dimensions=dims,
                                      shape=shape, seed_data="random:0,1",
                                      **kw)


# programs with blocks inside the (j, k) domain at the given tiles (and
# ragged last tiles), one per boundary condition, the hdiff DAG with
# rings of one step, the hdiff SDFG fixture as imported (stages that
# assign one name twice), a J = 1 rows plan, and the 1-, 2- and 8-byte
# types
SCHED = {
    "jacobi-constant": (_synth("diffusion", (8, 40, 44), 3,
                               boundary_value=0.5), (4, 8)),
    "jacobi-copy": (_synth("diffusion", (8, 40, 44), 3, boundary="copy"),
                    (4, 8)),
    "jacobi-shrink": (_synth("diffusion", (8, 40, 44), 3,
                             boundary="shrink"), (4, 8)),
    "hdiff-dag": (_synth("hdiff", (5, 52, 60), 2), (4, 8)),
    "hdiff-sdfg": (lambda: sdfg_to_program(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "fixtures", "hdiff.sdfg"), dimensions=(5, 20, 28),
        input_data="random:0,1"), (4, 8)),
    "hotspot": (_synth("hotspot", (6, 36, 44), 3), (4, 8)),
    "rows": (lambda: rotate_2d_to_rows(port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(24, 120), shape="diffusion",
        seed_data="random:0,1"))), (1, 16)),
    "fuzz-f64-shrink": (lambda: random_program(
        np.random.default_rng(5), ndim=3, data_type="float64",
        bc_kinds=("constant", "copy", "shrink")), (2, 8)),
    "fuzz-i32": (lambda: random_program(
        np.random.default_rng(6), ndim=3, data_type="int32",
        data="random:-20,20"), (2, 8)),
    "fuzz-i16": (lambda: random_program(
        np.random.default_rng(6), ndim=3, data_type="int16",
        data="random:-20,20"), (2, 8)),
    "fuzz-i8": (lambda: random_program(
        np.random.default_rng(8), ndim=3, data_type="int8",
        data="random:-5,5"), None),
}


def _program(make):
    spec = make()
    return spec if isinstance(spec, port.ir.Program) else \
        port.parse_program(spec)


def _twin(p, plan, tmp_path, seed=3):
    """(g++ build of the kernel, plain version, oracle) outputs."""
    an = port.ChainAnalysis.run(p)
    inputs = port.load_input_arrays(p, seed=seed)
    got = run_source(codegen.panel_source(p, an, plan), p, inputs, [],
                     tmp_path)
    want = panel.panel_plain(p, an, plan, spanned_arrays(p, inputs))
    oracle = port.run_interpreter(p, inputs)
    return got, {o: v.numpy() for o, v in want.items()}, oracle


def _equal(got, want, oracle):
    for o in oracle:
        g = got[o].reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, want[o].reshape(g.shape))
        np.testing.assert_array_equal(g, oracle[o])


@pytest.mark.parametrize("tile", [None, (2, 8)])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_twin_matches_plain_and_oracle(name, tile, tmp_path):
    """The parity programs of test_torch_panel.py (the examples, hotspot
    and the five fuzz seeds), at the planner's tile and a small one."""
    p = port.parse_program(PROGRAMS[name]())
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    _equal(*_twin(p, plan, tmp_path))


@pytest.mark.parametrize("name", sorted(SCHED))
def test_twin_schedule_fixtures(name, tmp_path):
    make, tile = SCHED[name]
    p = _program(make)
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    _equal(*_twin(p, plan, tmp_path))


def test_fixtures_cover_both_bodies():
    """The boundary fixtures have blocks of both kinds and steps of both
    kinds; hdiff's DAG packs its rings of one step."""
    for name in ("jacobi-constant", "jacobi-copy", "jacobi-shrink",
                 "hdiff-dag", "hotspot", "rows"):
        make, tile = SCHED[name]
        p = _program(make)
        plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
        ntj, ntk = plan.grid(p.dimensions)
        assert 0 < plan.inner_blocks(p) < ntj * ntk, name
        assert 0 < plan.masked_share(p) < 1, name
    make, tile = SCHED["hdiff-dag"]
    p = _program(make)
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    assert plan.span and plan.smem_bytes(p) < plan.unpacked_bytes(p)


def _overlaps(p, plan):
    """Pairs of rings live in a common phase whose bytes overlap."""
    offs = plan.ring_offsets(p)
    size = {f: -(-plan.slots(f) * plan.plane_bytes(f, p) // 16) * 16
            for f in plan.ring}
    bad = []
    for a in plan.ring:
        for b in plan.ring:
            if a >= b:
                continue
            shared = (a in plan.span and b in plan.span
                      and not plan.live_mask(a) & plan.live_mask(b))
            if not shared and offs[a] < offs[b] + size[b] \
                    and offs[b] < offs[a] + size[a]:
                bad.append((a, b))
    assert max(offs[f] + size[f] for f in plan.ring) <= offs[""]
    return bad


@pytest.mark.parametrize("tile", [(8, 16), (16, 16), (16, 32), (32, 32)])
def test_packed_layout_never_overlaps_live_rings(tile):
    p = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(256,) * 3, shape="hdiff"))
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    assert len(plan.span) > 20 and not _overlaps(p, plan)
    for name in ("jacobi3d", "hdiff", "forked_box", "fuzz127"):
        q = port.parse_program(PROGRAMS[name]())
        assert not _overlaps(q, panel.PanelPlan.build(
            port.ChainAnalysis.run(q)))


def test_hdiff256_packs_to_a_wide_tile():
    """hdiff3d 256^3 x 8 (31 of its 33 rings live within one step) fits
    (16, 32) and (32, 32) in a block's shared memory once packed; unpacked
    it fits neither.  The planner picks a tile of at least (16, 32)."""
    p = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(256,) * 3, shape="hdiff"))
    an = port.ChainAnalysis.run(p)
    for tile in ((16, 32), (32, 32)):
        plan = panel.PanelPlan.build(an, tile)
        assert plan.smem_bytes(p) <= H100_SMEM_PER_BLOCK \
            < plan.unpacked_bytes(p)
    pick = panel.PanelPlan.build(an)
    assert pick.smem_bytes(p) <= H100_SMEM_PER_BLOCK
    assert pick.tile[0] >= 16 and pick.tile[1] >= 16 \
        and pick.tile[0] * pick.tile[1] >= 16 * 32


def _block(src):
    return src[src.index("SF_DEV void sf_panel_block"):
               src.index("#ifdef __CUDACC__\n__global__")]


def test_ring_reads_have_no_modulo():
    """Every ring read is a slot base (set once per stage and step) plus
    the thread's cell and a constant: no % or / in a read, no % at all
    in the block but constant strides."""
    for name in ("jacobi3d", "hdiff", "fuzz101", "fuzz127"):
        p = port.parse_program(PROGRAMS[name]())
        an = port.ChainAnalysis.run(p)
        body = _block(codegen.panel_source(p, an,
                                           panel.PanelPlan.build(an)))
        reads = re.findall(r"b_\w+\[[^\]]*\]", body)
        assert reads, name
        for r in reads:
            assert "%" not in r and "/" not in r, r
            assert re.fullmatch(r"b_\w+_\d+\[(p|x\d+) \+ -?\d+\]", r), r
        assert set(re.findall(r"%\s*\w+", body)) <= {
            f"% {w}" for w in re.findall(r"SF_NT % (\d+)", body)}


def test_inputs_load_a_step_ahead():
    """The plane in flight: a prologue issues plane 0; step t issues
    plane t + AHEAD into its own slot, then waits for plane t, before the
    barrier and the first stage; an input ring has AHEAD more slots."""
    p = port.parse_program(PROGRAMS["jacobi3d"]())
    an = port.ChainAnalysis.run(p)
    plan = panel.PanelPlan.build(an)
    body = _block(codegen.panel_source(p, an, plan))
    loop = body[body.index("for (int t = 0;"):]
    issue = loop.index(f"(t + {panel.AHEAD})")
    assert "sf_cp4(r_a" in loop[:loop.index("SF_CP_WAIT_AHEAD();")]
    assert issue < loop.index("SF_CP_WAIT_AHEAD();") \
        < loop.index("SF_SYNC();") < loop.index("// stage")
    assert "sf_cp4(r_a" in body[:body.index("for (int t = 0;")]
    assert plan.slots("a") == plan.ring["a"] + panel.AHEAD
    assert plan.ring_offsets(p)["s0"] - plan.ring_offsets(p)["a"] == \
        -(-plan.slots("a") * plan.plane_bytes("a", p) // 16) * 16


def test_every_block_mask_free_shows(tmp_path, monkeypatch):
    """Taking the mask-free body in boundary blocks breaks the result."""
    make, tile = SCHED["jacobi-constant"]
    p = _program(make)
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    monkeypatch.setattr(panel, "reach", lambda program, plan: (0, 0))
    got, want, _ = _twin(p, plan, tmp_path)
    assert not all(np.array_equal(got[o], want[o]) for o in want)


def test_overlapping_pack_shows(tmp_path, monkeypatch):
    """Rings of one step placed on top of each other break the result."""
    make, tile = SCHED["hdiff-dag"]
    p = _program(make)
    an = port.ChainAnalysis.run(p)

    def one_offset(items, base, cap=0):
        items = list(items)
        return ({key: base for _p, key, _n, _m, _e in items}, {}, {},
                base + max(n for _p, _k, n, _m, _e in items))
    monkeypatch.setattr(panel, "place_by_phase", one_offset)
    plan = panel.PanelPlan.build(an, tile)
    got, want, _ = _twin(p, plan, tmp_path)
    assert not all(np.array_equal(got[o], want[o]) for o in want)


def test_no_slot_for_the_plane_in_flight_shows(tmp_path, monkeypatch):
    """Loading plane t + 1 into a ring without its extra slot overwrites
    a plane the step still reads."""
    p = _program(SCHED["jacobi-copy"][0])
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), (4, 8))
    monkeypatch.setattr(plan, "slots", lambda f: plan.ring[f])
    got, want, _ = _twin(p, plan, tmp_path)
    assert not all(np.array_equal(got[o], want[o]) for o in want)
