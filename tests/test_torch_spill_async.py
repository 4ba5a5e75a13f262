"""The spill rung's layout and generated code (K3c), on the CPU.

The stream kernel of a spill-rung plan packs shared memory by liveness
over the phases of a plane step, stages every spilled ring's new plane
in shared memory and moves planes between shared and device memory with
bulk asynchronous copies completed on mbarriers (``stream.pack_layout``,
``codegen._packed_stream_body``).  Held here: the layout (no two items
live in one phase overlap, regions at multiples of 128 bytes, planes at
multiples of 16, every load issued no later than its first reader and
in its step), the generated code (a
stage reads only shared memory; only bulk copies touch the spill
buffer), the host twin's sensitivity (a load issued after its readers
shows as a mismatch against the plain version), and that plans off the
rung generate the same source as before the rung was redesigned.  The
kernels' values against ``stream_plain`` and the oracle are held in
test_torch_spill.py; on the card, tests/test_torch_cuda.py and
chip_smoke.py run them.
"""
import hashlib
import re

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.dense import chain_halo
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.config import H100_SMEM_PER_BLOCK
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_torch_spill import PROGRAMS
from test_torch_stream import run_host


def _synth(shape, dims, n, **kw):
    return port.parse_program(synthesize_stencil(
        num_stages=n, dimensions=dims, shape=shape, seed_data="random:0,1",
        **kw))


def _plan(name):
    make, kw = PROGRAMS[name]
    return stream.plan_stream(port.parse_program(make()), **kw), kw


def _item_bytes(plan, key):
    if isinstance(key, str):
        return plan.ring_bytes(key)
    f = key[1]
    return plan.ring_bytes(f) if key[0] == "ring" else plan.plane_bytes(f)


def _check_layout(plan, budget):
    lay = plan.spill_layout()
    assert plan.smem_bytes() == lay.end <= budget
    # every region at a multiple of 128 bytes, planes at multiples of 16
    assert all(off % 128 == 0 for off in lay.offset.values())
    assert all(plan.plane_bytes(f) % 16 == 0 for f in plan.raw_ring)
    soffs = plan.spill_offsets()
    assert all(v % 128 == 0 for v in soffs.values())
    # the barriers, then the rings kept across steps, then the arena
    arena = [k for k in lay.offset if not isinstance(k, str)]
    rings = sorted((lay.offset[f], lay.offset[f] + plan.ring_bytes(f))
                   for f in lay.offset if isinstance(f, str))
    floor = 8 * len(lay.loads)
    for lo, hi in rings:
        assert lo >= floor
        floor = hi
    assert all(lay.offset[k] >= floor for k in arena)
    # arena items live in a common phase never overlap
    for i, a in enumerate(arena):
        for b in arena[i + 1:]:
            if lay.live[a] & lay.live[b]:
                a0, b0 = lay.offset[a], lay.offset[b]
                assert (a0 + _item_bytes(plan, a) <= b0
                        or b0 + _item_bytes(plan, b) <= a0), (a, b)
        assert lay.offset[a] + _item_bytes(plan, a) <= lay.end
    # loads: one per delta beyond the producer's lag of every spilled
    # ring, issued no later than their first reader and in their step,
    # live until their last reader
    n = plan.phases()
    assert sorted(lay.loads) == sorted(
        (f, d) for f in plan.spilled for d in plan.read_phases()[f]
        if d > plan.lag[f])
    for key in lay.loads:
        issue, readers = lay.issue[key], lay.readers[key]
        assert 0 <= issue <= readers[0] and readers[-1] < n
        live = lay.live[("read",) + key]
        assert all(live >> ph & 1 for ph in range(issue, readers[-1] + 1))
    # a staging plane lives until its last reader in the step
    for f in plan.spilled:
        same = plan.read_phases()[f].get(plan.lag[f], [])
        assert all(lay.live["stage", f] >> ph & 1 for ph in same)
    return lay


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_layout_packs_without_overlap(name):
    plan, kw = _plan(name)
    assert plan.packed
    _check_layout(plan, kw.get("smem_budget", H100_SMEM_PER_BLOCK))


@pytest.mark.parametrize("shape,size,iters", [
    ("diffusion", 512, 32), ("hdiff", 256, 16), ("hotspot", 256, 32)])
def test_deep_cell_layouts(shape, size, iters):
    """By planning only, at full size: the route's layouts hold the same
    rules, and most spilled planes are loaded at least a phase ahead of
    their readers in the bytes the layout needs anyway."""
    p = _synth(shape, (size,) * 3, iters)
    plan = stream.plan_stream(p, mxu="off")
    lay = _check_layout(plan, H100_SMEM_PER_BLOCK)
    if plan.spilled:
        ahead = sum(lay.issue[k] < lay.readers[k][0] for k in lay.loads)
        assert 2 * ahead > len(lay.loads)
        # one plane written per spilled ring and one loaded per load
        assert plan.spill_traffic() == sum(
            plan.plane_bytes(f) for f in plan.spilled) + sum(
            plan.plane_bytes(k[0]) for k in lay.loads)


def test_rings_of_one_step_share_space():
    """hdiff's rings all live within one plane step: packed by liveness,
    they take less shared memory than one region each."""
    p = _synth("hdiff", (8, 40, 48), 2)
    plan = stream.plan_stream(p, tile=(8, 8), spill="all")
    assert all(plan.in_step(f) for f in plan.raw_ring)
    unpacked = sum(plan.ring_bytes(f) for f in plan.raw_ring)
    plan.spilled = {}
    assert plan.spill_layout().end < unpacked
    _check_layout(plan, H100_SMEM_PER_BLOCK)


def test_spilled_stage_code_reads_only_shared_memory():
    """No stage reads a spilled ring from device memory: the spill buffer
    appears only in the block's region pointer and in the bulk copies,
    every spilled ring has a staging plane in shared memory and no ring
    pointer, and each load's readers wait on its mbarrier."""
    plan, _kw = _plan("jacobi3d_all")
    src = stream.stream_source(plan)
    head = src.index("SF_DEV void sf_stream_block")
    body = src[src.index(") {\n", head):src.index(
        "#ifdef __CUDACC__\n__global__")]
    for line in body.splitlines():
        if "sf_region" in line or "sf_spill" in line:
            assert ("sf_bulk_store(sf_region" in line
                    or "sf_bulk_load(" in line
                    or "unsigned char* const sf_region = sf_spill" in line)
    for f in plan.spilled:
        assert f"* const st_{f} = " in body and f"(sf_smem + " in body
        assert not re.search(rf"\br_{f}\b", body)
    lay = plan.spill_layout()
    for i in range(len(lay.loads)):
        assert f"sf_mbar_wait(sf_bar + {i}, par);" in body
        assert f", sf_bar + {i});" in body
    assert body.count("sf_bulk_store(") == len(plan.spilled)
    assert "SF_BULK_WAIT_READ();" in body and "SF_FENCE_ASYNC();" in body
    # the CUDA side is Hopper's bulk copies, the host side memcpy
    for op in ("cp.async.bulk.global.shared::cta.bulk_group",
               "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx",
               "mbarrier.try_wait.parity", "fence.proxy.async.shared::cta"):
        assert op in src


def test_a_load_after_its_readers_shows(tmp_path):
    """The host twin runs a load where it is issued: a load issued after
    its readers leaves them NaN or a stale plane, which the comparison
    with the plain version catches."""
    plan, _kw = _plan("jacobi3d_all")
    p = plan.program
    inputs = port.load_input_arrays(p, seed=2)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    got = run_host(plan, inputs, tmp_path)
    o = p.outputs[0]
    np.testing.assert_array_equal(got[o], want[o].numpy())
    lay = plan.spill_layout()
    for key in lay.loads:
        lay.issue[key] = plan.phases() - 1   # after every reader
    late = run_host(plan, inputs, tmp_path)
    assert not np.array_equal(late[o], want[o].numpy())


# sha256 (16 hex digits) of the generated source after its stage
# functions, for plans off the spill rung (the on-chip body), and (tile,
# shared-memory bytes) of the full-size plans: a change to the spill rung
# moves none of them
UNSPILLED = {
    "box_r2_composed": "9e83c82e50bd6830",
    "cross_r2_banded": "a894d70bcba7f16a",
    "jacobi_per_cell": "ecac74c2c43d7c05",
    "hdiff_per_cell": "5802ee98aaf99b00",
    "jacobi_local_k4": "3a0ebf902d59cb6d",
    "box3d_256_8_r2": ("5b9d1b8c58c49a4f", (32, 8), 94976),
    "cross3d_256_8_r2": ("4f80c9c896200ff8", (16, 16), 224768),
    "jacobi3d_1024_8_chunk": ("39a775c178ccad3a", (16, 32), 107008),
}


def _unspilled(name):
    if name == "box_r2_composed":
        return stream.plan_stream(_synth("box", (20, 16, 16), 4, extent=2))
    if name == "cross_r2_banded":
        return stream.plan_stream(_synth("cross", (12, 14, 16), 3,
                                         extent=2))
    if name == "jacobi_per_cell":
        return stream.plan_stream(_synth("diffusion", (24, 24, 24), 3),
                                  mxu="off")
    if name == "hdiff_per_cell":
        return stream.plan_stream(_synth("hdiff", (8, 12, 16), 2),
                                  mxu="off")
    if name == "box3d_256_8_r2":
        return stream.plan_stream(_synth("box", (256,) * 3, 8, extent=2))
    if name == "cross3d_256_8_r2":
        return stream.plan_stream(_synth("cross", (256,) * 3, 8, extent=2))
    if name == "jacobi_local_k4":
        p, block = _synth("diffusion", (24, 24, 24), 3, boundary="copy"), 12
    else:
        p, block = _synth("diffusion", (1024,) * 3, 8), 128
    an = port.ChainAnalysis.run(p)
    return stream.plan_local(p, an, block, chain_halo(an)[0])


@pytest.mark.parametrize("name", sorted(UNSPILLED))
def test_unspilled_source_unchanged(name):
    plan = _unspilled(name)
    assert not plan.packed and not plan.spilled
    src = stream.stream_source(plan)
    digest = hashlib.sha256(src[src.index(
        "#ifdef __CUDACC__\n#define SF_DEV"):].encode()).hexdigest()[:16]
    want = UNSPILLED[name]
    if isinstance(want, tuple):
        assert (digest, plan.tile, plan.smem_bytes()) == want
    else:
        assert digest == want
    assert "SF_BULK" not in src and "sf_bulk" not in src


def test_spill_all_option():
    """``spill="all"`` takes the spill rung on a program that fits on chip
    and equals the oracle; other values are refused."""
    p = _synth("diffusion", (12, 16, 16), 3)
    assert not stream.plan_stream(p).packed
    fn = stream.compile_chain_stream(p, spill="all", device="cpu")
    assert fn.plan.packed and fn.last_config["spilled"] == ["a", "s0", "s1"]
    inputs = port.load_input_arrays(p, seed=3)
    np.testing.assert_array_equal(fn(inputs)[p.outputs[0]].numpy(),
                                  port.run_interpreter(p, inputs)[
                                      p.outputs[0]])
    with pytest.raises(ValueError, match="spill"):
        stream.check_spill("some")
