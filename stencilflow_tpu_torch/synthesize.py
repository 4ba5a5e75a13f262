"""Synthetic stencil-program generator.

Parity with the reference's benchmark generator
(bin/synthesize.py:34-298): emits program dicts (the JSON
dialect) for parameterized chains — number of stages, domain sizes, stencil
shape (cross / box / diffusion / hotspot), stencil extent, fork frequency and
length, vectorization, and how often a fresh spatial input joins the chain.

The port's copy of ``stencilflow_tpu/synthesize.py``, plus ``random_program``:
the differential-fuzz generator of ``tests/test_fuzz.py`` (same draws for the
same generator state), extended with dtype and boundary-condition choices so
``chip_smoke.py`` can cover shrink BCs and f64 / int32 fields on the card.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

SHAPES = ("cross", "box", "diffusion", "hotspot", "hdiff")


def _iterators(num_dims: int) -> List[str]:
    return ["i", "j", "k"][3 - num_dims:]


def _center(iters: Sequence[str]) -> str:
    return "[" + ", ".join(iters) + "]"


def _offset_index(iters: Sequence[str], offsets: Sequence[int]) -> str:
    parts = []
    for it, o in zip(iters, offsets):
        if o == 0:
            parts.append(it)
        elif o > 0:
            parts.append(f"{it}+{o}")
        else:
            parts.append(f"{it}-{-o}")
    return "[" + ", ".join(parts) + "]"


def _cross_accesses(num_dims: int, extent: int) -> List[List[int]]:
    """Von-Neumann (cross) footprint of the given radius."""
    acc = [[0] * num_dims]
    for d in range(num_dims):
        for e in range(1, extent + 1):
            for s in (-e, e):
                v = [0] * num_dims
                v[d] = s
                acc.append(v)
    return acc


def _box_accesses(num_dims: int, extent: int) -> List[List[int]]:
    rng = range(-extent, extent + 1)
    return [list(v) for v in itertools.product(*([rng] * num_dims))]


def _stencil_expression(name: str, field: str, num_dims: int, shape: str,
                        extent: int) -> str:
    iters = _iterators(num_dims)
    if shape == "cross":
        accs = _cross_accesses(num_dims, extent)
    elif shape == "box":
        accs = _box_accesses(num_dims, extent)
    elif shape == "diffusion":
        # jacobi-style diffusion: center-weighted cross of radius 1
        accs = _cross_accesses(num_dims, 1)
        terms = " + ".join(field + _offset_index(iters, a) for a in accs[1:])
        return f"{name} = {1.0 / (2 * num_dims):.8f} * ({terms})"
    elif shape == "hotspot":
        return _hotspot_expression(name, field, num_dims)
    else:
        raise ValueError(f"unknown stencil shape: {shape}")
    coeff = 1.0 / len(accs)
    terms = " + ".join(field + _offset_index(iters, a) for a in accs)
    return f"{name} = {coeff:.8f} * ({terms})"


def _hotspot_expression(name: str, field: str, num_dims: int) -> str:
    """Hotspot thermal-simulation update (2-D/3-D), with scalar coefficient
    inputs cap/ct as in the reference's synthesizer (bin/synthesize.py:131-273).
    ``power`` is a full-size auxiliary input field."""
    iters = _iterators(num_dims)
    c = _center(iters)
    if num_dims == 2:
        j, k = iters
        return (f"{name} = {field}{c} + cap * (power{c} "
                f"+ 0.1 * ({field}[{j}+1, {k}] + {field}[{j}-1, {k}] "
                f"- 2.0 * {field}{c}) "
                f"+ 0.1 * ({field}[{j}, {k}+1] + {field}[{j}, {k}-1] "
                f"- 2.0 * {field}{c}) "
                f"+ ct * (80.0 - {field}{c}))")
    i, j, k = iters
    return (f"{name} = {field}{c} + cap * (power{c} "
            f"+ 0.1 * ({field}[{i}+1, {j}, {k}] + {field}[{i}-1, {j}, {k}] "
            f"- 2.0 * {field}{c}) "
            f"+ 0.1 * ({field}[{i}, {j}+1, {k}] + {field}[{i}, {j}-1, {k}] "
            f"- 2.0 * {field}{c}) "
            f"+ 0.1 * ({field}[{i}, {j}, {k}+1] + {field}[{i}, {j}, {k}-1] "
            f"- 2.0 * {field}{c}) "
            f"+ ct * (80.0 - {field}{c}))")


def _hdiff_stage(stage: int, prev: str, iters: Sequence[str],
                 data_type: str, bc) -> Dict[str, Dict]:
    """One COSMO-style horizontal-diffusion block: lap → flux-limited
    flx/fly → out (the canonical multi-operator import target named in the
    reference paper; the reference reaches it through its SDFG importer,
    sdfg_to_stencilflow.py:522).  Offsets live in the two fastest (plane)
    dims only — the vertical dim streams — and the flux limiters exercise
    multi-statement kernels, temporaries, compares, and ternaries."""
    c = _center(iters)
    # offset helpers in the last two dims (j, k of the padded program)
    def off(field, dj=0, dk=0):
        o = [0] * len(iters)
        o[-2] += dj
        o[-1] += dk
        return field + _offset_index(iters, o)

    lap, flx, fly, out = (f"lap{stage}", f"flx{stage}", f"fly{stage}",
                          f"s{stage}")
    kernels = {
        lap: {
            "computation_string":
                f"{lap} = 4.0 * {off(prev)} - ({off(prev, -1, 0)} + "
                f"{off(prev, 1, 0)} + {off(prev, 0, -1)} + "
                f"{off(prev, 0, 1)})",
            "boundary_conditions": bc(prev),
            "data_type": data_type,
        },
        flx: {
            "computation_string":
                f"d = {off(lap, 1, 0)} - {off(lap)}; "
                f"{flx} = 0.0 if d * ({off(prev, 1, 0)} - {off(prev)}) "
                f"> 0.0 else d",
            "boundary_conditions": {**bc(lap), **bc(prev)},
            "data_type": data_type,
        },
        fly: {
            "computation_string":
                f"d = {off(lap, 0, 1)} - {off(lap)}; "
                f"{fly} = 0.0 if d * ({off(prev, 0, 1)} - {off(prev)}) "
                f"> 0.0 else d",
            "boundary_conditions": {**bc(lap), **bc(prev)},
            "data_type": data_type,
        },
        out: {
            "computation_string":
                f"{out} = {off(prev)} - coeff{c} * "
                f"({off(flx)} - {off(flx, -1, 0)} + "
                f"{off(fly)} - {off(fly, 0, -1)})",
            "boundary_conditions": {**bc(flx), **bc(fly), **bc(prev),
                                    **bc("coeff")},
            "data_type": data_type,
        },
    }
    return kernels


def synthesize_stencil(num_stages: int = 4,
                       dimensions: Sequence[int] = (64, 64, 64),
                       shape: str = "diffusion",
                       extent: int = 1,
                       data_type: str = "float32",
                       vectorization: int = 1,
                       fork_frequency: int = 0,
                       fork_length: int = 1,
                       input_frequency: int = 0,
                       boundary: str = "constant",
                       boundary_value: float = 0.0,
                       seed_data: str = "constant:1.0") -> Dict:
    """Build a synthetic chain program dict.

    ``fork_frequency``: every N stages, fork a side chain of ``fork_length``
    stages that rejoins via addition.  ``input_frequency``: every N stages
    a fresh full-size input array is added into the chain.
    """
    num_dims = len(dimensions)
    if not 1 <= num_dims <= 3:
        raise ValueError("dimensions must be 1-3 entries")
    iters = _iterators(num_dims)
    center = _center(iters)

    def bc(field: str) -> Dict:
        return {field: {"type": boundary, "value": boundary_value}}

    inputs: Dict[str, Dict] = {
        "a": {"data": seed_data, "data_type": data_type},
    }
    program: Dict[str, Dict] = {}
    prev = "a"
    extra_inputs = 0

    if shape in ("diffusion", "hotspot") and extent != 1:
        raise ValueError(
            f"shape {shape!r} has a fixed radius-1 footprint; extent "
            "only applies to cross/box")
    if shape == "hotspot":
        if num_dims < 2:
            raise ValueError("hotspot needs >= 2 dimensions")
        inputs["power"] = {"data": "constant:0.5", "data_type": data_type}
        inputs["cap"] = {"data": 0.5, "data_type": data_type,
                         "input_dims": []}
        inputs["ct"] = {"data": 0.05, "data_type": data_type,
                        "input_dims": []}
    elif shape == "hdiff":
        if num_dims < 2:
            raise ValueError("hdiff needs >= 2 dimensions")
        if extent != 1 or fork_frequency or input_frequency:
            raise ValueError(
                "hdiff is a fixed 4-kernel block per stage; extent / "
                "fork_frequency / input_frequency do not apply")
        if seed_data == "constant:1.0":
            # constant input makes lap ≡ 0 and the limiters degenerate
            inputs["a"]["data"] = "random:0.0,1.0"
        inputs["coeff"] = {"data": "constant:0.025", "data_type": data_type}
        for s in range(num_stages):
            program.update(_hdiff_stage(s, prev, iters, data_type, bc))
            prev = f"s{s}"
        spec = {
            "inputs": inputs,
            "outputs": [prev],
            "dimensions": list(dimensions),
            "program": program,
        }
        if vectorization > 1:
            spec["vectorization"] = vectorization
        return spec

    for s in range(num_stages):
        name = f"s{s}"
        expr = _stencil_expression(name, prev, num_dims, shape, extent)
        conditions = bc(prev)
        if shape == "hotspot":
            conditions.update(bc("power"))
        if input_frequency and s > 0 and s % input_frequency == 0:
            extra_inputs += 1
            iname = f"in{extra_inputs}"
            inputs[iname] = {"data": f"constant:{0.1 * extra_inputs:.2f}",
                             "data_type": data_type}
            expr += f" + {iname}{center}"
            conditions.update(bc(iname))
        if fork_frequency and s > 0 and s % fork_frequency == 0:
            fork_prev = prev
            for f in range(fork_length):
                fname = f"f{s}_{f}"
                fexpr = _stencil_expression(fname, fork_prev, num_dims,
                                            "diffusion", 1)
                program[fname] = {
                    "computation_string": fexpr,
                    "boundary_conditions": bc(fork_prev),
                    "data_type": data_type,
                }
                fork_prev = fname
            expr += f" + {fork_prev}{center}"
            conditions.update(bc(fork_prev))
        program[name] = {
            "computation_string": expr,
            "boundary_conditions": conditions,
            "data_type": data_type,
        }
        prev = name

    spec = {
        "inputs": inputs,
        "outputs": [prev],
        "dimensions": list(dimensions),
        "program": program,
    }
    if vectorization > 1:
        spec["vectorization"] = vectorization
    return spec


def jacobi(num_dims: int, size: int, iterations: int = 1,
           data_type: str = "float32", vectorization: int = 1,
           boundary: str = "constant") -> Dict:
    """Canonical jacobi2d/jacobi3d iteration-chain workloads
    (the reference's headline benchmarks, test/stencils/jacobi*.json)."""
    return synthesize_stencil(
        num_stages=iterations,
        dimensions=(size,) * num_dims,
        shape="diffusion",
        data_type=data_type,
        vectorization=vectorization,
        boundary=boundary,
    )


def _offset_str(iters, offs):
    parts = []
    for it, o in zip(iters, offs):
        parts.append(it if o == 0 else (f"{it}+{o}" if o > 0
                                        else f"{it}-{-o}"))
    return "[" + ", ".join(parts) + "]"


def random_program(rng: np.random.Generator, ndim: int = 0,
                   data_type: str = "float32",
                   bc_kinds: Sequence[str] = ("constant", "copy"),
                   data: str = "random:-1,1") -> Dict:
    """Random stencil chain: forks/joins, ternaries, min/abs, mixed
    offsets and BCs, a (k) static input, an (i, k) partial input (3-D)
    and a scalar.  With the default arguments it draws exactly what
    ``tests/test_fuzz.py::make_random_program`` draws from the same
    generator state; ``data_type`` types every field, ``bc_kinds`` are
    the boundary conditions drawn from, ``data`` is the inputs' source."""
    ndim = ndim or int(rng.integers(2, 4))
    dims = [int(rng.integers(4, 9)) for _ in range(ndim)]
    iters = ["i", "j", "k"][3 - ndim:]
    n_stages = int(rng.integers(2, 6))

    def rand_access(field):
        offs = [int(rng.integers(-2, 3)) for _ in range(ndim)]
        return field + _offset_str(iters, offs)

    def rand_expr(avail, depth=0):
        r = rng.random()
        if depth > 2 or r < 0.35:
            choice = rng.random()
            if choice < 0.6:
                return rand_access(str(rng.choice(avail)))
            if choice < 0.75:
                return f"{rng.uniform(-2, 2):.3f}"
            if choice < 0.85:
                return "sc"
            if choice < 0.93 or ndim == 2:
                return "row" + _offset_str(["k"],
                                           [int(rng.integers(-1, 2))])
            return "ik" + _offset_str(
                ["i", "k"], [int(rng.integers(-1, 2)),
                             int(rng.integers(-1, 2))])
        if r < 0.75:
            op = {"add": "+", "sub": "-", "mult": "*"}[
                str(rng.choice(["add", "sub", "mult"]))]
            return (f"({rand_expr(avail, depth + 1)} {op} "
                    f"{rand_expr(avail, depth + 1)})")
        if r < 0.85:
            return (f"min({rand_expr(avail, depth + 1)}, "
                    f"{rand_expr(avail, depth + 1)})")
        if r < 0.95:
            return (f"({rand_expr(avail, depth + 1)} if "
                    f"{rand_expr(avail, depth + 1)} > 0.0 else "
                    f"{rand_expr(avail, depth + 1)})")
        return f"abs({rand_expr(avail, depth + 1)})"

    inputs = {
        "a": {"data": data, "data_type": data_type},
        "row": {"data": data, "data_type": data_type,
                "input_dims": ["k"]},
        "sc": {"data": float(rng.uniform(-1, 1)), "data_type": data_type,
               "input_dims": []},
    }
    if ndim == 3:
        inputs["ik"] = {"data": data, "data_type": data_type,
                        "input_dims": ["i", "k"]}
    program = {}
    avail = ["a"]
    for s in range(n_stages):
        name = f"s{s}"
        expr = rand_expr(avail)
        if s > 0:
            expr = f"({expr} + {rand_access(avail[-1])})"
        used = sorted({f for f in ["a", "row", "ik"] + avail
                       if f in expr})
        bcs = {}
        for f in used:
            kind = str(rng.choice(list(bc_kinds)))
            bcs[f] = {"type": kind, "value": float(rng.uniform(-1, 1))}
        program[name] = {
            "computation_string": f"{name} = {expr}",
            "boundary_conditions": bcs,
            "data_type": data_type,
        }
        avail.append(name)
    return {
        "inputs": inputs,
        "outputs": [avail[-1]],
        "dimensions": dims,
        "program": program,
    }


# -- programs of many types (the stream kernel's compute types, the
#    simulator's native core, the narrow floats) -------------------------

# the draw ``mixed_dtype_spec`` takes: the first from seed 0 up with an
# int32, a bool and a floating stage whose C++ simulator core is generated
# (held by tests/test_torch_compute_types.py)
MIXED_DTYPE_SEED = 3


def mixed_dtype_spec(dims, seed: int = MIXED_DTYPE_SEED):
    """A chain with a dtype per kernel (float32 / float64 / int32 / int16
    / bool; edges carry the producer's dtype), drawn from ``seed`` as
    ``tests/test_fuzz.py::make_mixed_dtype_program`` draws (the port's
    ``random_program`` types every field alike), at ``dims``.  Returns
    (spec, name)."""
    rng = np.random.default_rng(seed)
    for _ in range(3):   # the generator's dims, replaced by ``dims``
        rng.integers(4, 8)

    def acc(field):
        offs = [int(rng.integers(-1, 2)) for _ in range(3)]
        return field + _offset_str(["i", "j", "k"], offs)

    def fconst():
        return f"{float(rng.uniform(-2, 2))!r}"
    avail = [("a", "float32"), ("n", "int32")]
    prog = {}
    for s in range(int(rng.integers(3, 6))):
        name = f"s{s}"
        dt = str(rng.choice(["float32", "float64", "int32", "int16",
                             "bool"]))
        (x, xdt), (y, ydt) = picks = [
            avail[-1], avail[int(rng.integers(0, len(avail)))]]

        def term(f, fdt):
            a = acc(f)
            if fdt == "bool":
                return f"({a} * {int(rng.integers(1, 4))})"
            return a
        if dt == "bool":
            expr = f"({term(x, xdt)} > {term(y, ydt)})"
        elif dt.startswith("int"):
            expr = (f"({term(x, xdt)} * {int(rng.integers(1, 4))} "
                    f"- {term(y, ydt)} + {int(rng.integers(-5, 8))})")
            if rng.random() < 0.4:
                expr = f"min({expr}, {term(x, xdt)})"
            if rng.random() < 0.3:
                expr = f"abs({expr})"
        else:
            expr = f"({term(x, xdt)} * {fconst()} + {term(y, ydt)})"
            if rng.random() < 0.4:
                expr = (f"({expr} if {term(x, xdt)} > {fconst()} "
                        f"else {term(y, ydt)})")
        bcs = {}
        for f, fdt in dict(picks).items():
            if fdt == "bool":
                bcs[f] = {"type": "constant", "value": 0}
            elif fdt.startswith("int"):
                bcs[f] = {"type": "constant",
                          "value": int(rng.integers(0, 5))}
            else:
                bcs[f] = {"type": str(rng.choice(["constant", "copy"])),
                          "value": float(round(rng.uniform(-1, 1) * 64)
                                         / 64)}
        prog[name] = {"computation_string": f"{name} = {expr}",
                      "boundary_conditions": bcs, "data_type": dt}
        avail.append((name, dt))
    spec = {"inputs": {"a": {"data": "random:-1,1", "data_type": "float32"},
                       "n": {"data": "random:1,40", "data_type": "int32"}},
            "outputs": [avail[-1][0]], "dimensions": list(dims),
            "program": prog}
    return spec, f"mixed_dtype_{seed}"


def narrow_mixed_spec(dims):
    """A bf16 chain with transcendentals, a bf16 scalar, a copy and a
    shrink BC, float constants pinned to bf16, and an int32 stage that
    casts bf16 values (the oracle's lattice at every kind of site; the
    int32 stage reads the inputs alone, so its cells stay exact)."""
    bf = "bfloat16"
    return {"inputs": {"b": {"data": "random:-2,3", "data_type": bf},
                       "g": {"data": "random:-2,3", "data_type": bf,
                             "input_dims": []}},
            "outputs": ["s", "z"], "dimensions": list(dims),
            "program": {
                "u": {"computation_string":
                      "u = exp(b[i,j,k] * 0.5) + tanh(b[i,j+1,k]) - "
                      "sqrt(abs(b[i,j,k-1])) + g",
                      "boundary_conditions": {"b": {"type": "shrink"}},
                      "data_type": bf},
                "s": {"computation_string":
                      "s = u[i,j,k] / (u[i+1,j,k] + 3.0) if u[i,j,k] > 1.0 "
                      "else -u[i,j,k]",
                      "boundary_conditions": {"u": {"type": "copy"}},
                      "data_type": bf},
                "z": {"computation_string":
                      "z = b[i,j,k] * 4.0 + min(b[i,j+1,k], g)",
                      "boundary_conditions":
                      {"b": {"type": "constant", "value": 0.3}},
                      "data_type": "int32"}}}
