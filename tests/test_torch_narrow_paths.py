"""Programs typed bfloat16 and float16 on K4, K6 and the entry points above
them, against the oracle and the JAX package.

(a) The plain versions of K4 (chunk, shard with non-zero origins,
segment) and K6 (masked, fast) against the port's oracle, bit for bit,
for bf16 and f16 x (diffusion, hdiff) x (constant, copy, shrink) BCs,
each driven through its entry point on the CPU (``run_chunked``,
``run_sharded_chain``, ``compile_pipeline_split`` with the stream body,
``run_chain_tile``).
(b) The generated K4 (chunk, shard) and K6 (masked, fast) sources, built
with g++ (``sf_host_launch``; bf16 in the bf16 macros' ``uint16_t``,
float16 as a struct on the host), against the plain versions and the
oracle, bit for bit; the narrow macros appear in narrow programs' sources
only.
(c) The JAX package's interpret-mode K4 (``outofcore.run_chunked``) and
K6 (``compile_chain_pallas``), its sharded engine (2 x 2 and 2 x 2 x 2
virtual devices), its pipeline, ``iterate`` (fused, checkpointed),
``fast_value_and_grad``, ``value_and_grad`` and ``solve_cg``, all run in
one subprocess with ``--xla_allow_excess_precision=false`` (XLA's CPU
compiler otherwise keeps fused narrow intermediates in float32), against
the port: bit for bit on bf16, and on f16 where the JAX kernel equals its
own oracle (its K6 on f16 does not: pinned below).  Reductions (the loss
value, ``value_and_grad``, ``solve_cg``) within ``BF16_VERIFY_RTOL``
(bf16) or 5e-3 (f16) of the largest magnitude.
(d) ``iterate`` resumes its own bf16 checkpoints to BFLOAT16 and the JAX
package's (raw ``|V2`` voids, which the JAX package itself cannot
resume: pinned below); ``autotune``'s winner equals the oracle; the
routing ladder plans narrow programs where it plans float32 ones; the CLI
runs every entry point on a bf16 program.
"""
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch import dtypes
from stencilflow_tpu_torch.backend import stream, tile
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.dense import chain_halo, compile_chain
from stencilflow_tpu_torch.cli import main
from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL
from stencilflow_tpu_torch.outofcore import _host_slab, run_chunked
from stencilflow_tpu_torch.parallel.domain import (_widen_and_origin,
                                                   place_global_inputs,
                                                   run_sharded_chain)
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.parallel.pipeline import compile_pipeline_split
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_torch_domain_sched import _build, _shard_plan
from test_torch_stream import run_source

NARROW = ["bfloat16", "float16"]
SHORT = {"bfloat16": "bf16", "float16": "f16"}
SEED = 3
# the reductions' tolerance, of the largest magnitude
RTOL = {"bfloat16": BF16_VERIFY_RTOL, "float16": 5e-3}


def bits(x):
    """A narrow array's 2-byte patterns (any other array as it is)."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 and \
        x.dtype.kind in "fV" else x


def synth(shape, dt, bc="constant"):
    """diffusion 8 x 12 x 16 x 3 or hdiff 8 x 16 x 16 x 2 (its halo
    needs 8-wide shards on a 2 x 2 mesh), typed ``dt``."""
    dims, iters = ((8, 16, 16), 2) if shape == "hdiff" else ((8, 12, 16), 3)
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0.0,1.0", data_type=dt,
                              boundary=bc)


def jacobi_typed(dt, n=8, iters=2):
    spec = jacobi(3, n, iterations=iters)
    for k in spec["program"].values():
        k["data_type"] = dt
    spec["inputs"]["a"]["data_type"] = dt
    return spec


def euler_typed(dt, n=8):
    """The backward-Euler operator y = x - 0.3 lap(x) (SPD), typed
    ``dt`` (``solver_cells.implicit_diffusion``)."""
    return {"inputs": {"x": {"data": "constant:0.0", "data_type": dt}},
            "outputs": ["y"], "dimensions": [n, n, n],
            "program": {"y": {
                "computation_string": "y = x[i, j, k] - 0.3 * (x[i-1, j, k]"
                " + x[i+1, j, k] + x[i, j-1, k] + x[i, j+1, k] + "
                "x[i, j, k-1] + x[i, j, k+1] - 6.0 * x[i, j, k])",
                "boundary_conditions": {"x": {"type": "constant",
                                              "value": 0.0}},
                "data_type": dt}}}


def _equal(got, oracle):
    for o in oracle:
        g = dtypes.to_numpy(got[o]) if torch.is_tensor(got[o]) else \
            np.asarray(got[o])
        g = g.reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype, o
        np.testing.assert_array_equal(bits(g), bits(oracle[o]), err_msg=o)


def _program(spec, seed=SEED):
    p = port.parse_program(spec, name="narrow")
    inputs = port.load_input_arrays(p, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # shrink's junk overflows f16
        oracle = port.run_interpreter(p, inputs)
    return p, inputs, oracle


def _run(mode, p, inputs):
    """The program through ``mode``'s entry point on the CPU (the
    kernel's plain version)."""
    if mode == "K4-chunk":
        return run_chunked(p, inputs, 2, device="cpu", backend="stream")
    if mode == "K4-shard":
        return run_sharded_chain(p, make_mesh(["cpu"], (2, 2), ("x", "y")),
                                 (None, "x", "y"), inputs,
                                 local_backend="stream")
    if mode == "K4-segment":
        fn, _ = compile_pipeline_split(p, make_mesh(["cpu"], (2,), ("p",)),
                                       "p", local_backend="stream")
        assert fn.last_config["backend"] == "stream"
        return {k: v.numpy() for k, v in fn(inputs).items()}
    return tile.run_chain_tile(p, inputs, mode=mode[3:], device="cpu")


MODES = ["K4-chunk", "K4-shard", "K4-segment", "K6-masked", "K6-fast"]


# -- (a) the plain versions against the oracle --------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bc", ["constant", "copy", "shrink"])
@pytest.mark.parametrize("shape", ["diffusion", "hdiff"])
@pytest.mark.parametrize("dt", NARROW)
def test_plain_matches_oracle(dt, shape, bc, mode):
    p, inputs, oracle = _program(synth(shape, dt, bc))
    _equal(_run(mode, p, inputs), oracle)


def test_k4_and_k6_count_narrow_launches_by_mode():
    """A narrow program's plans count under "local_narrow" /
    "shard_narrow" (K4) and "narrow" (K6); float32's under their own."""
    from stencilflow_tpu_torch.backend.stacked_io import launch_mode
    p = port.parse_program(synth("diffusion", "bfloat16"))
    an = port.ChainAnalysis.run(p)
    h = chain_halo(an)[0]
    chunk = stream.plan_local(p, an, 4, h)
    shard = stream.plan_local(p, an, 4, h, shard=(6, 8), xhalo=(3, 3))
    assert stream._mode(chunk) == "local_narrow"
    assert stream._mode(shard) == "shard_narrow"
    assert launch_mode(tile.plan_tile(p, an).program) == "narrow"
    f32 = port.parse_program(synth("diffusion", "float32"))
    assert stream._mode(stream.plan_local(f32, None, 4, h)) == "local"


@pytest.mark.parametrize("dt", NARROW)
def test_ring_options_on_a_narrow_program(dt):
    """bf16 ring storage and single-pass bf16 band passes on a narrow
    program do what the JAX package's do on its narrow rings: nothing
    (``ring_storage`` rounds float32 rings only, ``rs_round``), and the
    port keeps narrow stages per cell, so no pass is banded; the result
    equals the oracle bit for bit and the plan is the default one."""
    p, inputs, oracle = _program(synth("diffusion", dt))
    an = port.ChainAnalysis.run(p)
    h = chain_halo(an)[0]
    base = stream.plan_local(p, an, 4, h)
    for kw in ({"ring_storage": "bfloat16"}, {"mxu_precision": "bf16"}):
        plan = stream.plan_local(p, an, 4, h, **kw)
        assert not plan.rounds and not plan.bf16_passes
        assert not plan.mxu_plans
        assert plan.smem_bytes() == base.smem_bytes()
        assert stream.stream_source(plan) == stream.stream_source(base)
    _equal(run_chunked(p, inputs, 2, device="cpu",
                       mxu_precision="bf16"), oracle)
    _equal(run_sharded_chain(p, make_mesh(["cpu"], (2, 2), ("x", "y")),
                             (None, "x", "y"), inputs,
                             ring_storage="bfloat16",
                             local_backend="stream"), oracle)


# -- (b) the generated sources through g++ ------------------------------------

def _k4_chunk_host(p, inputs, plan, chunks, tmp_path):
    lib = _build(stream.stream_source(plan), tmp_path)
    import ctypes
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    I, h, Ic = p.dimensions[0], plan.halo_i, plan.block
    blob = scalar_blob(p, inputs)
    outs = {o: [] for o in p.outputs}
    for c in range(chunks):
        lo = c * Ic - h
        slabs = {n: _host_slab(np.asarray(inputs[n]), lo, lo + Ic + 2 * h, I)
                 for n, s in p.inputs.items() if not s.is_scalar}
        want = stream.local_stream_plain(plan, lo, slabs)
        arrays = [dtypes.to_numpy(slabs[n]) for n, s in p.inputs.items()
                  if not s.is_scalar]
        got = [np.zeros((Ic,) + p.dimensions[1:], p.kernels[o].dtype)
               for o in p.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
        op = (ctypes.c_void_p * len(got))(*[a.ctypes.data for a in got])
        lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                           blob.ctypes.data, lo)
        for o, g in zip(p.outputs, got):
            np.testing.assert_array_equal(bits(g),
                                          bits(dtypes.to_numpy(want[o])))
            outs[o].append(g)
    return {o: np.concatenate(v) for o, v in outs.items()}


def _k4_shard_host(p, inputs, tmp_path):
    import ctypes
    _p, plan, splan = _shard_plan(p, ((2, 2), ("x", "y"), (None, "x", "y")),
                                  {}, False)
    lib = _build(stream.stream_source(splan), tmp_path)
    per = _widen_and_origin(plan, place_global_inputs(p, plan, inputs))
    blob = scalar_blob(p, inputs)
    outs = {o: np.zeros(p.dimensions, p.kernels[o].dtype)
            for o in p.outputs}
    origins = set()
    for c, tiles in per.items():
        oi, oj, ok = plan.block_origin(c)
        origins.add((oj, ok))
        want = stream.local_stream_plain(splan, oi - plan.halo[0], tiles,
                                         oj, ok, plan.instance(c))
        arrays = [dtypes.to_numpy(tiles[n]) for n, s in p.inputs.items()
                  if not s.is_scalar]
        got = [np.zeros((plan.block[0],) + splan.core(), p.kernels[o].dtype)
               for o in p.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
        op = (ctypes.c_void_p * len(got))(*[a.ctypes.data for a in got])
        lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                           blob.ctypes.data, oi - plan.halo[0], oj, ok)
        core = tuple(slice(o, o + b) for o, b in zip((oi, oj, ok),
                                                      plan.block))
        for o, g in zip(p.outputs, got):
            np.testing.assert_array_equal(bits(g),
                                          bits(dtypes.to_numpy(want[o])))
            outs[o][core] = g
    assert any(oj > 0 and ok > 0 for oj, ok in origins)
    return outs


def _k4_shards_host(p, inputs, shard, xhalo, tmp_path):
    """Every shard of a (J / Bj) x (K / Bk) grid of (Bj, Bk) = ``shard``
    cores through K4's shard-mode source built with g++ (inputs widened
    by ``xhalo``, zero beyond the domain), each held to its plain
    version; the assembled outputs, and the plan."""
    import ctypes
    an = port.ChainAnalysis.run(p)
    I, J, K = p.dimensions
    (bj, bk), (xj, xk) = shard, xhalo
    plan = stream.plan_local(p, an, I, 0, mxu="off", shard=shard,
                             xhalo=xhalo)
    lib = _build(stream.stream_source(plan), tmp_path)
    blob = scalar_blob(p, inputs)
    outs = {o: np.zeros(p.dimensions, p.kernels[o].dtype)
            for o in p.outputs}
    for oj in range(0, J, bj):
        for ok in range(0, K, bk):
            tiles = {}
            for n, spec in p.inputs.items():
                if spec.is_scalar:
                    tiles[n] = dtypes.to_torch(inputs[n])
                    continue
                a = np.asarray(inputs[n])
                w = np.zeros((I, bj + 2 * xj, bk + 2 * xk), a.dtype)
                js, ks = max(0, oj - xj), max(0, ok - xk)
                je, ke = min(J, oj + bj + xj), min(K, ok + bk + xk)
                w[:, js - oj + xj:je - oj + xj, ks - ok + xk:ke - ok + xk] = \
                    a[:, js:je, ks:ke]
                tiles[n] = dtypes.to_torch(w)
            want = stream.local_stream_plain(plan, 0, tiles, oj, ok)
            arrays = [dtypes.to_numpy(tiles[n]) for n, s in p.inputs.items()
                      if not s.is_scalar]
            got = [np.zeros((I, bj, bk), p.kernels[o].dtype)
                   for o in p.outputs]
            ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                                   for a in arrays])
            op = (ctypes.c_void_p * len(got))(*[a.ctypes.data for a in got])
            lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                               blob.ctypes.data, 0, oj, ok)
            for o, g in zip(p.outputs, got):
                np.testing.assert_array_equal(bits(g),
                                              bits(dtypes.to_numpy(want[o])))
                outs[o][:, oj:oj + bj, ok:ok + bk] = g
    return outs, plan


# the loader's alignment branches on K4's shards (``stacked_io.copy_group``):
# mode -> (dims, shard core, exchanged halo, cells a cp.async moves)
SHARDS = {"K4-shard-oddhalo": ((6, 12, 16), (6, 8), (3, 3), 1),
          "K4-shard-oddcore": ((6, 12, 14), (6, 7), (4, 4), 1),
          "K4-shard-groups": ((6, 12, 16), (6, 8), (4, 4), 2)}
GXX = [(dt, shape, mode) for dt in NARROW
       for shape, mode in [("diffusion", "K4-chunk"), ("hdiff", "K4-shard"),
                           ("diffusion", "K6-masked"), ("hdiff", "K6-fast")]
       + [("diffusion", m) for m in sorted(SHARDS)]]


@pytest.mark.parametrize("dt,shape,mode", GXX)
def test_generated_kernel_matches_plain_and_oracle(dt, shape, mode,
                                                   tmp_path):
    """The CUDA source built with g++: 2-byte storage (ring inputs loaded
    by ``cp.async`` groups where the plan aligns them: memcpy on the
    host), each op rounded once, bit for bit against the plain version
    and the oracle; K4's chunks start at odd i origins (-3 and 1), and
    its shards take every branch of the loader's alignment."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    if mode in SHARDS:
        dims, shard, xhalo, g = SHARDS[mode]
        spec = synthesize_stencil(num_stages=3, dimensions=dims,
                                  shape=shape, seed_data="random:0.0,1.0",
                                  data_type=dt)
        p, inputs, oracle = _program(spec)
        got, plan = _k4_shards_host(p, inputs, shard, xhalo, tmp_path)
        assert plan.copy_groups.get("a", 1) == g
        _equal(got, oracle)
        return
    p, inputs, oracle = _program(synth(shape, dt, "copy" if shape == "hdiff"
                                       else "constant"))
    an = port.ChainAnalysis.run(p)
    if mode == "K4-chunk":
        plan = stream.plan_local(p, an, 4, chain_halo(an)[0])
        assert plan.copy_groups == {"a": 2}   # halo 3 widened to 4
        src = stream.stream_source(plan)
        got = _k4_chunk_host(p, inputs, plan, 2, tmp_path)
    elif mode == "K4-shard":
        got = _k4_shard_host(p, inputs, tmp_path)
        src = None
    else:
        plan = tile.plan_tile(p, an, tile=(2, 4, 8), mode=mode[3:])
        src = tile.tile_source(plan)
        got = run_source(src, p, inputs, [], tmp_path)
        plain = tile.tile_plain(plan, {n: dtypes.to_torch(v).reshape(
            p.dimensions) if not p.inputs[n].is_scalar else
            dtypes.to_torch(v) for n, v in inputs.items()})
        _equal(got, {o: dtypes.to_numpy(v) for o, v in plain.items()})
    assert src is None or "sf_d2hr" in src
    _equal(got, oracle)


def test_misaligned_groups_are_refused():
    """An input loaded by cp.async groups must start at a multiple of a
    group's bytes (``check_aligned``, before every launch), and a shard's
    k origin at a multiple of the group (``run_local_stream``): both
    raise, with no quiet switch to synchronous loads."""
    from stencilflow_tpu_torch.backend.stacked_io import check_aligned
    base = torch.zeros(64, dtype=torch.bfloat16)
    check_aligned({"a": base}, {"a": 8})
    check_aligned({"a": base[2:]}, {"a": 2})
    for view, g in ((base[1:], 2), (base[2:], 8)):
        with pytest.raises(ValueError, match="not aligned"):
            check_aligned({"a": view}, {"a": g})
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(6, 12, 16), shape="diffusion",
        seed_data="random:0.0,1.0", data_type="bfloat16"))
    an = port.ChainAnalysis.run(p)
    plan = stream.plan_local(p, an, 6, 0, mxu="off", shard=(6, 8),
                             xhalo=(4, 4))
    assert plan.copy_groups == {"a": 2}
    slab = torch.zeros((6, 14, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k origin 7"):
        stream.run_local_stream(plan, 0, {"a": slab}, None, 0, 7)


def test_narrow_macros_in_narrow_sources_only():
    """The float32 program's K4 (chunk, shard) and K6 sources carry no
    narrow conversion (their FROZEN hashes hold, tests/
    test_torch_stream_sched.py); the narrow program's do, and differ
    from the float32 ones."""
    srcs = {}
    for dt in ["float32"] + NARROW:
        p = port.parse_program(synth("diffusion", dt))
        an = port.ChainAnalysis.run(p)
        h = chain_halo(an)[0]
        srcs[dt] = [
            stream.stream_source(stream.plan_local(p, an, 4, h)),
            stream.stream_source(stream.plan_local(
                p, an, 4, h, shard=(6, 8), xhalo=(3, 3))),
            tile.tile_source(tile.plan_tile(p, an, tile=(2, 4, 8),
                                            mode="fast"))]
    for s in srcs["float32"]:
        assert "sf_d2hr" not in s and "sf_bfr" not in s and "sf_hr" not in s
    for dt in NARROW:
        for s, f in zip(srcs[dt], srcs["float32"]):
            assert s != f and "sf_d2hr" in s
            assert ("sf_bfr(" if dt == "bfloat16" else "sf_hr(") in s


# -- (c) against the JAX package ----------------------------------------------

_JAX_SCRIPT = r"""
import json, os, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import stencilflow_tpu as ref
from stencilflow_tpu.backend.pallas import compile_chain_pallas
from stencilflow_tpu.grad import fast_value_and_grad, value_and_grad
from stencilflow_tpu.iterate import iterate
from stencilflow_tpu.outofcore import run_chunked
from stencilflow_tpu.parallel.domain import run_sharded_chain
from stencilflow_tpu.parallel.pipeline import run_pipeline_split
from stencilflow_tpu.backend.stream import compile_chain_stream
from stencilflow_tpu.solve import solve_cg
cases = json.load(open(sys.argv[1]))
work = sys.argv[3]
out = {}


def put(name, got):
    for o, v in got.items():
        v = np.asarray(v)
        out[name + "/" + o] = v.view(np.uint16) if v.dtype.itemsize == 2 \
            and v.dtype.kind in "fV" else v


def mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))


for name, c in cases.items():
    p = ref.parse_program(c["spec"], name="narrow")
    inputs = ref.load_input_arrays(p, seed=%d)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    kind = c["kind"]
    if kind == "chunk":
        put(name, run_chunked(p, inputs, 2, interpret=True,
                              backend="stream"))
    elif kind in ("masked", "fast"):
        put(name, compile_chain_pallas(p, interpret=True, mode=kind)(jin))
    elif kind == "domain":
        put(name, run_sharded_chain(p, mesh(*c["mesh"][:2]),
                                    tuple(c["mesh"][2]), inputs))
    elif kind == "pipeline":
        put(name, run_pipeline_split(p, mesh((c["positions"],), ("p",)),
                                     "p", inputs))
    elif kind == "iterate":
        put(name, iterate(p, inputs, c["steps"], fuse=c["fuse"],
                          backend="xla"))
    elif kind == "checkpoint":
        d = os.path.join(work, name)
        put(name, iterate(p, inputs, c["steps"], backend="xla"))
        iterate(p, inputs, c["every"], backend="xla",
                checkpoint_every=c["every"], checkpoint_dir=d)
        try:
            iterate(p, inputs, c["steps"], backend="xla",
                    checkpoint_every=c["every"], checkpoint_dir=d)
            out[name + "/resume_error"] = np.array("")
        except Exception as e:
            out[name + "/resume_error"] = np.array(
                f"{type(e).__name__}: {e}")
    elif kind in ("fvg", "vg"):
        f = fast_value_and_grad(p, interpret=True) if kind == "fvg" \
            else value_and_grad(p)
        value, grads = f(jin)
        put(name, grads)
        out[name + "/value"] = np.float64(np.asarray(value, np.float32))
    elif kind == "compute_f16":
        put(name, compile_chain_stream(p, interpret=True,
                                       compute_dtype="float16",
                                       **c["kw"])(jin))
    elif kind == "cg":
        rhs = np.asarray(c["rhs"], np.float64).astype(
            jnp.dtype(p.inputs["x"].dtype))
        x, info = solve_cg(p, jnp.asarray(rhs), maxiter=c["maxiter"],
                           tol=c["tol"], interpret=True)
        put(name, {"x": x})
        out[name + "/iterations"] = np.int64(info["iterations"])
        out[name + "/residual"] = np.float64(info["residual"])
np.savez(sys.argv[2], **out)
""" % SEED

DOMAIN = {"2x2": [(2, 2), ("x", "y"), (None, "x", "y")],
          "2x2x2": [(2, 2, 2), ("x", "y", "z"), ("x", "y", "z")]}
# (fast mode on bf16 diffusion only: interpret mode takes two seconds a
# case there)
JAX_KERNELS = {
    f"{m}-{SHORT[dt]}-{shape}": (lambda dt=dt, shape=shape, bc=bc:
                                 synth(shape, dt, bc), m)
    for dt in NARROW for m in ("chunk", "masked", "fast")
    for shape, bc in (("diffusion", "constant"), ("hdiff", "copy"))
    if m != "fast" or (shape == "diffusion" and dt == "bfloat16")}
JAX_PATHS = {
    **{f"domain{m}-{SHORT[dt]}": (lambda dt=dt: synth("diffusion", dt),
                                  "domain", {"mesh": DOMAIN[m]})
       for dt in NARROW for m in DOMAIN},
    **{f"pipeline-{SHORT[dt]}": (lambda dt=dt: synth("hdiff", dt, "copy"),
                                 "pipeline", {"positions": 4})
       for dt in NARROW},
    **{f"iterate-{SHORT[dt]}": (lambda dt=dt: jacobi_typed(dt), "iterate",
                                {"steps": 4, "fuse": 2}) for dt in NARROW},
    "checkpoint-bf16": (lambda: jacobi_typed("bfloat16"), "checkpoint",
                        {"steps": 4, "every": 2}),
    **{f"{k}-{SHORT[dt]}": (lambda dt=dt: jacobi_typed(dt, 8, 2), k, {})
       for dt in NARROW for k in ("fvg", "vg")},
}


def _cg_rhs(n=8):
    return np.random.default_rng(11).random((n, n, n)).round(3).tolist()


for _dt in NARROW:
    JAX_PATHS[f"cg-{SHORT[_dt]}"] = (lambda dt=_dt: euler_typed(dt), "cg",
                                     {"rhs": _cg_rhs(), "maxiter": 4,
                                      "tol": 1e-6})


# compute_dtype="float16" on float32 programs: K3a (per cell), K3b (split
# band passes on f16 operands) and K3c (the spill rung)
COMPUTE_F16 = {
    "compute_f16-K3a": (lambda: jacobi(3, 12, iterations=2), {}),
    "compute_f16-K3b": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(10, 12, 16), shape="box", extent=2,
        seed_data="random:0,1", boundary_value=0.3), {}),
    "compute_f16-K3c": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(12, 12, 12), shape="diffusion",
        seed_data="random:0,1"), {"spill": "all"}),
}
for _n, (_make, _kw) in COMPUTE_F16.items():
    JAX_PATHS[_n] = (_make, "compute_f16", {"kw": _kw})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every JAX case in one subprocess whose XLA rounds narrow values
    after every operation, on 8 virtual CPU devices."""
    d = tmp_path_factory.mktemp("jax_narrow_paths")
    cases = {n: {"spec": make(), "kind": kind}
             for n, (make, kind) in JAX_KERNELS.items()}
    cases.update({n: {"spec": make(), "kind": kind, **extra}
                  for n, (make, kind, extra) in JAX_PATHS.items()})
    (d / "cases.json").write_text(json.dumps(cases))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(flags + " --xla_allow_excess_precision=false")
               .strip())
    env.pop("PYTEST_XDIST_WORKER", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(d / "cases.json"), str(d / "out.npz"),
                           str(d)], cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz")), d


def _truth(make, inputs, o):
    """The program typed float64 on the same values: the float64 truth."""
    spec = make()
    for v in list(spec["inputs"].values()) + list(spec["program"].values()):
        v["data_type"] = "float64"
    return port.run_interpreter(port.parse_program(spec), {
        k: dtypes.cast(v, np.float64) for k, v in inputs.items()})[o]


# the JAX package's interpret-mode kernels that differ from its own oracle
# on float16 with the flag set (test_jax_f16_kernels_differ_from_their_oracle)
JAX_OFF = {"chunk-f16-hdiff", "masked-f16-hdiff"}
# the same of its pipeline's XLA segment body (hdiff typed float16)
JAX_PATH_OFF = {"pipeline-f16"}
_MODE = {"chunk": "K4-chunk", "masked": "K6-masked", "fast": "K6-fast"}


@pytest.mark.parametrize("name", sorted(JAX_KERNELS))
def test_kernels_match_the_jax_kernels(name, jax_runs):
    """K4's and K6's plain versions against the JAX package's
    interpret-mode kernels: bit for bit, but for the recorded f16
    departures of the JAX kernels from their own oracle."""
    got, _d = jax_runs
    make, kind = JAX_KERNELS[name]
    p, inputs, oracle = _program(make())
    mine = _run(_MODE[kind], p, inputs)
    _equal(mine, oracle)
    for o in oracle:
        off = int((got[f"{name}/{o}"].reshape(oracle[o].shape)
                   != bits(oracle[o])).sum())
        assert (off > 0) == (name in JAX_OFF), (name, off)


@pytest.mark.parametrize("name", sorted(JAX_OFF))
def test_jax_f16_kernels_differ_from_their_oracle(name, jax_runs):
    """A fault of the reference, recorded (ROADMAP Queue 3): on float16
    the JAX package's interpret-mode K6 and K4 on hdiff differ from its
    oracle in some cells even with the flag (the same 58 cells in K4, K6
    and its pipeline's XLA body; its fast K6 on diffusion too, not run
    here: ROADMAP Queue 3); the port's plain versions equal the oracle,
    which is nearer the float64 truth on average."""
    got, _d = jax_runs
    make, kind = JAX_KERNELS[name]
    p, inputs, oracle = _program(make())
    o = p.outputs[0]
    j = got[f"{name}/{o}"].reshape(oracle[o].shape).view(np.float16) \
        .astype(np.float64)
    w = oracle[o].astype(np.float64)
    off = int((j != w).sum())
    assert off > 0
    truth = _truth(make, inputs, o)
    rel = np.abs(j - w) / (np.maximum(np.abs(j), np.abs(w)) +
                           np.finfo(np.float64).eps)
    print(f"{name}: the JAX kernel differs from its oracle in {off} of "
          f"{w.size} cells, max abs {np.abs(j - w).max():.4g}, max rel "
          f"{rel.max():.4g}; mean abs from the float64 truth: oracle "
          f"{np.abs(w - truth).mean():.4g}, JAX kernel "
          f"{np.abs(j - truth).mean():.4g}")
    assert np.abs(w - truth).mean() <= np.abs(j - truth).mean()


def _port_path(name, p, inputs, tmp_path):
    make, kind, extra = JAX_PATHS[name]
    if kind == "domain":
        shape, names, axes = extra["mesh"]
        mesh = make_mesh(["cpu"], shape, names)
        return [run_sharded_chain(p, mesh, axes, inputs, local_backend=b)
                for b in ("auto", "stream")]
    if kind == "pipeline":
        mesh = make_mesh(["cpu"], (extra["positions"],), ("p",))
        return [{k: v.numpy() for k, v in compile_pipeline_split(
            p, mesh, "p", local_backend=b)[0](inputs).items()}
            for b in ("auto", "stream")]
    if kind == "iterate":
        return [port.iterate(p, inputs, extra["steps"], fuse=extra["fuse"],
                             backend=b, device="cpu")
                for b in ("auto", "tile")]
    raise AssertionError(kind)


@pytest.mark.parametrize("name", sorted(
    n for n, v in JAX_PATHS.items()
    if v[1] in ("domain", "pipeline", "iterate")))
def test_entry_points_match_the_jax_package(name, jax_runs, tmp_path):
    """run-distributed (domain on 2 x 2 and 2 x 2 x 2 virtual shards,
    pipeline over 4 positions: the dense tile body and K4's plain
    version) and fused ``iterate`` (K1's and K6's plain versions) bit
    for bit against the oracle, and so against the JAX package, whose
    pipeline departs from its oracle on hdiff typed float16 (58 cells,
    as its kernels do: ``JAX_PATH_OFF``)."""
    got, _d = jax_runs
    make, kind, extra = JAX_PATHS[name]
    p, inputs, oracle = _program(make())
    if kind == "iterate":   # the oracle stepped by hand
        state = dict(inputs)
        for _ in range(extra["steps"]):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                state["a"] = port.run_interpreter(p, state)[p.outputs[0]]
        oracle = {"a": state["a"]}
    for mine in _port_path(name, p, inputs, tmp_path):
        _equal(mine, oracle)
    for o in oracle:
        off = int((got[f"{name}/{o}"].reshape(oracle[o].shape)
                   != bits(oracle[o])).sum())
        assert (off > 0) == (name in JAX_PATH_OFF), (name, off)


def test_iterate_resumes_bf16_checkpoints(jax_runs, tmp_path):
    """A bf16 ``step_*.npz`` resumes to BFLOAT16, the port's own and the
    JAX package's (ml_dtypes arrays saved as raw ``|V2`` voids); each run
    starts from zeros, so only a resumed state reaches the JAX package's
    uninterrupted 4 steps, bit for bit."""
    got, d = jax_runs
    make, _kind, extra = JAX_PATHS["checkpoint-bf16"]
    p, inputs, _oracle = _program(make())
    want = got["checkpoint-bf16/a"]
    every, steps = extra["every"], extra["steps"]
    zeros = {k: (dtypes.cast(np.zeros_like(v, np.float32), v.dtype)
                 if np.ndim(v) else v) for k, v in inputs.items()}
    own = tmp_path / "own"
    port.iterate(p, inputs, every, device="cpu", checkpoint_every=every,
                 checkpoint_dir=str(own))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    shutil.copy(d / "checkpoint-bf16" / f"step_{every}.npz", jax_dir)
    for ckpt, kind in ((own, dtypes.BFLOAT16), (jax_dir, np.dtype("V2"))):
        with np.load(ckpt / f"step_{every}.npz") as z:
            assert z["a"].dtype == kind
        res = port.iterate(p, zeros, steps, device="cpu",
                           checkpoint_every=every, checkpoint_dir=str(ckpt))
        assert res["a"].dtype == dtypes.BFLOAT16
        np.testing.assert_array_equal(bits(res["a"]).reshape(want.shape),
                                      want)


def test_jax_package_cannot_resume_its_bf16_checkpoints(jax_runs):
    """A fault of the reference, recorded (ROADMAP Queue 3): the JAX
    package's ``iterate`` writes bf16 state as ``|V2`` and its resume
    raises TypeError (``stencilflow_tpu/iterate.py:316``); the port
    resumes those files (above)."""
    got, _d = jax_runs
    err = str(got["checkpoint-bf16/resume_error"])
    assert err.startswith("TypeError") and "|V2" in err


def _close(a, b, dt, what):
    a = dtypes.cast(dtypes.to_numpy(a) if torch.is_tensor(a) else a,
                    np.float64)
    b = dtypes.cast(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-30)
    assert float(np.max(np.abs(a - b))) <= RTOL[dt] * scale, what


@pytest.mark.parametrize("dt", NARROW)
def test_fast_value_and_grad_matches_the_jax_package(dt, jax_runs):
    """The gradient fields bit for bit against the JAX package's and the
    port's dense lowering of the adjoint program on the same cotangent;
    the loss value (a reduction) within the tolerance."""
    from stencilflow_tpu_torch.grad import _adjoint_extras
    got, _d = jax_runs
    name = f"fvg-{SHORT[dt]}"
    p, inputs, _oracle = _program(JAX_PATHS[name][0]())
    f = port.fast_value_and_grad(p, device="cpu")
    value, grads = f(inputs)
    adj, cot = port.adjoint_program(p, ["a"])
    o = p.outputs[0]
    ones = torch.ones(tuple(p.raw_dimensions),
                      dtype=dtypes.to_torch_dtype(p.kernels[o].dtype))
    dense = compile_chain(adj)({cot[o]: ones, **{
        k: dtypes.to_torch(v) for k, v in _adjoint_extras(adj, cot).items()}})
    g = dtypes.to_numpy(grads["a"])
    assert g.dtype == np.dtype(p.inputs["a"].dtype)
    np.testing.assert_array_equal(bits(g), got[f"{name}/a"].reshape(g.shape))
    np.testing.assert_array_equal(
        bits(g), bits(dtypes.to_numpy(dense["adj_a"]).reshape(g.shape)))
    _close(np.float64(float(value)), np.float64(got[f"{name}/value"]), dt,
           "value")


@pytest.mark.parametrize("dt", NARROW)
def test_value_and_grad_matches_the_jax_package(dt, jax_runs):
    """Dense autodiff in torch's narrow types: value and gradient within
    the tolerance of the JAX package's (the reductions run in another
    order), the gradient in the field's type."""
    got, _d = jax_runs
    name = f"vg-{SHORT[dt]}"
    p, inputs, _oracle = _program(JAX_PATHS[name][0]())
    value, grads = port.value_and_grad(p, device="cpu")(inputs)
    g = dtypes.to_numpy(grads["a"])
    assert g.dtype == np.dtype(p.inputs["a"].dtype)
    want = got[f"{name}/a"].reshape(g.shape).view(g.dtype)
    _close(g, want, dt, "gradient")
    _close(np.float64(float(value)), np.float64(got[f"{name}/value"]), dt,
           "value")


@pytest.mark.parametrize("dt", NARROW)
def test_solve_cg_matches_the_jax_package(dt, jax_runs):
    """CG at a fixed ``maxiter`` of 4 on the backward-Euler operator typed
    narrow: x within the tolerance of the JAX package's, the same
    iteration count, vectors and dots in the field's type."""
    got, _d = jax_runs
    name = f"cg-{SHORT[dt]}"
    make, _kind, extra = JAX_PATHS[name]
    p = port.parse_program(make())
    rhs = dtypes.cast(np.asarray(extra["rhs"], np.float64),
                      p.inputs["x"].dtype)
    x, info = port.solve_cg(p, rhs, maxiter=extra["maxiter"],
                            tol=extra["tol"], device="cpu")
    assert info["iterations"] == int(got[f"{name}/iterations"]) == 4
    xs = dtypes.to_numpy(x)
    assert xs.dtype == np.dtype(p.inputs["x"].dtype)
    _close(xs, got[f"{name}/x"].reshape(xs.shape).view(xs.dtype), dt, "x")
    assert np.isfinite(info["residual"])


# -- (d) autotune, the CLI ----------------------------------------------------

@pytest.mark.parametrize("dt", NARROW)
def test_autotune_winner_equals_the_oracle(dt):
    """``autotune`` on the CPU takes the candidates the JAX package builds
    for a narrow program (no bf16-ring labels: those round float32 rings
    only); its winner, and the winner rebuilt from its label, equal the
    oracle bit for bit."""
    from stencilflow_tpu_torch.autotune import (REDUCED_PRECISION_LABELS,
                                                autotune, build_from_label)
    p, inputs, oracle = _program(synth("diffusion", dt))
    res = autotune(p, device="cpu", trials=1,
                        allow_reduced_precision=True)
    assert not set(res.timings) & set(REDUCED_PRECISION_LABELS)
    assert {"stream", "panel:B=auto", "overlap:B=auto"} <= set(res.timings)
    _equal(res.fn(inputs), oracle)
    _equal(build_from_label(p, res.label, device="cpu")(inputs), oracle)


@pytest.fixture
def narrow_jsons(tmp_path, monkeypatch):
    """jacobi3d 8^3 x 2 and the backward-Euler operator at 8^3, typed
    bfloat16, as JSON files in the working directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    for name, spec in (("j.json", jacobi_typed("bfloat16")),
                       ("e.json", euler_typed("bfloat16"))):
        with open(name, "w") as f:
            json.dump(spec, f)
    return "j.json", "e.json"


@pytest.mark.parametrize("argv,said", [
    (["run", "--backend", "tile", "--device", "cpu",
      "--compare-to-reference"], "verified against reference: OK"),
    (["run", "--host-chunks", "2", "--device", "cpu",
      "--compare-to-reference"], "verified against reference: OK"),
    (["run-distributed", "--devices", "2", "--force-host-devices",
      "--compare-to-reference"], "verified against reference: OK"),
    (["iterate", "--steps", "2", "--device", "cpu"], "ran 2 steps"),
    (["solve", "--rhs", "random:0,1", "--emulation", "--tol", "1e-2"],
     "converged in"),
    (["autotune", "--device", "cpu", "--no-sweep", "--trials", "1"],
     "winner: ")])
def test_cli_entry_points_run_narrow_programs(narrow_jsons, capsys, argv,
                                              said):
    """The entry points that refused a bf16 program now run it (the
    solver on the backward-Euler operator, the rest on jacobi3d)."""
    jac, euler = narrow_jsons
    cmd = [argv[0], euler if argv[0] == "solve" else jac] + argv[1:]
    assert main(cmd) == 0
    assert said in capsys.readouterr().out


# -- compute_dtype="float16" ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(COMPUTE_F16))
def test_compute_f16_matches_the_jax_package(name, jax_runs, tmp_path):
    """float16 compute: every array, ring and stage in float16, each op
    in float32 rounded once (``sf_hr``), the split route's band passes
    on float16 operands (exact in TF32): the plain version equals the
    JAX package's interpret-mode stream kernel bit for bit, and the
    generated source, built with g++ on float16 arrays, equals the plain
    version; the float32 route differs."""
    got, _d = jax_runs
    make, kw = COMPUTE_F16[name]
    p = port.parse_program(make(), name="narrow")
    inputs = port.load_input_arrays(p, seed=SEED)
    fn = stream.compile_chain_stream(p, device="cpu",
                                     compute_dtype="float16", **kw)
    plan = fn.plan
    assert plan.compute_narrow == np.float16 and plan.io_itemsize("a") == 2
    assert bool(plan.mxu_plans) == name.endswith("K3b")
    assert plan.packed == name.endswith("K3c")
    mine = fn(inputs)
    f32 = stream.compile_chain_stream(p, device="cpu", **kw)(inputs)
    for o in p.outputs:
        g = mine[o].numpy()
        assert g.dtype == np.float32   # cast back to the program's type
        np.testing.assert_array_equal(g.reshape(-1),
                                      got[f"{name}/{o}"].reshape(-1))
        assert not np.array_equal(g, f32[o].numpy())
    if shutil.which("g++") is None:
        return
    src = stream.stream_source(plan)
    assert "sf_hr(" in src and "sf_f2h(" in src
    import ctypes
    lib = _build(src, tmp_path)
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3
    arrays = [np.asarray(inputs[n], np.float32).astype(np.float16)
              for n, sp in p.inputs.items() if not sp.is_scalar]
    arrays += [np.ascontiguousarray(a, np.float32)
               for _k, a in plan.kernel_pool()]
    outs = [np.zeros(p.dimensions, np.float16) for _o in p.outputs]
    ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
    lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                       scalar_blob(p, inputs).ctypes.data)
    for o, h in zip(p.outputs, outs):
        np.testing.assert_array_equal(h.astype(np.float32).reshape(-1),
                                      mine[o].numpy().reshape(-1))
