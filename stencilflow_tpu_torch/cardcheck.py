"""Helpers that hold a kernel against its plain version on the card,
shared by ``chip_smoke.py`` and the card tests (``tests/test_torch_cuda.py``):
the random chains of BC kinds, input ranks and dtypes, a jacobi that
reads i-offsets of 3, one chunk's input
slabs, K4's plan at a chunk count, and the comparison of two outputs of a
narrow type by their bits."""
from __future__ import annotations

import numpy as np

# the random chains (label, ``random_program`` keywords, rank)
FUZZ_VARIANTS = {
    "fuzz-f32": (dict(), 3),
    "fuzz-f64-shrink": (dict(data_type="float64",
                             bc_kinds=("constant", "copy", "shrink")), 3),
    "fuzz-i32": (dict(data_type="int32", data="random:-20,20"), 3),
    "fuzz-f32-shrink": (dict(bc_kinds=("shrink", "copy")), 3),
    "fuzz-f32-2d": (dict(bc_kinds=("constant", "copy", "shrink")), 2),
}


def fuzz_programs(labels=tuple(FUZZ_VARIANTS)):
    """[(label-seed, program)] of the random chains ``labels`` (of
    ``FUZZ_VARIANTS``): for each, the first draw from seed 1000 up that
    reads the scalar and the lower-rank input(s)."""
    from . import parse_program
    from .synthesize import random_program
    progs = []
    for label in labels:
        kw, ndim = FUZZ_VARIANTS[label]
        for seed in range(1000, 2000):
            spec = random_program(np.random.default_rng(seed), ndim=ndim,
                                  **kw)
            src = " ".join(k["computation_string"]
                           for k in spec["program"].values())
            need = ["sc", "row"] + (["ik"] if ndim == 3 else [])
            if all(n in src for n in need):
                progs.append((f"{label}-{seed}", parse_program(
                    spec, name="fuzz_" + label[len("fuzz-"):])))
                break
        else:
            raise RuntimeError(f"no fuzz draw for {label}")
    return progs


def wide_i_spec(dims, stages: int):
    """A 3-D jacobi whose stages read i-offsets of 3: windows wider than a
    panel of B = 2."""
    program, prev = {}, "a"
    for n in range(stages):
        program[f"s{n}"] = {
            "computation_string":
                f"s{n} = 0.2 * ({prev}[i-3,j,k] + {prev}[i+3,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k+1])",
            "boundary_conditions": {prev: {"type": "constant",
                                           "value": 0.5}},
            "data_type": "float32"}
        prev = f"s{n}"
    return {"inputs": {"a": {"data": "random:0.0,1.0",
                             "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims),
            "program": program}


def chunk_slabs(program, inputs, lo: int, Ii: int):
    """One chunk's inputs on the card: i-spanning ones as host slabs of
    ``Ii`` planes from global plane ``lo`` (zero outside the domain)."""
    from .dtypes import to_torch
    from .outofcore import _host_slab
    I = program.dimensions[0]
    slabs = {}
    for n, spec in program.inputs.items():
        a = np.asarray(inputs[n])
        if spec.is_scalar:
            slabs[n] = to_torch(a)
        elif spec.dim_mask[0]:
            slabs[n] = _host_slab(a, lo, lo + Ii, I).cuda()
        else:
            slabs[n] = to_torch(a, "cuda")
    return slabs


def local_plan(program, chunks: int, mxu_precision: str = "split"):
    """K4's plan of ``program`` at ``chunks`` chunks, as the out-of-core
    path chooses it (``plan_local_stream``)."""
    from .backend.dense import chain_halo
    from .frontend.analysis import ChainAnalysis
    from .parallel.domain import DomainDecomposition, plan_local_stream
    an = ChainAnalysis.run(program)
    I, J, K = program.dimensions
    h = chain_halo(an)[0] if chunks > 1 else 0
    got = plan_local_stream(program, an, DomainDecomposition(
        program, None, (None, None, None), (h, 0, 0), (I // chunks, J, K)),
        mxu_precision=mxu_precision)
    if got is None:
        raise RuntimeError(f"{program.name}: K4's planner refused")
    return got[0]


def narrow_held(got, want, rtol: float):
    """(ok, max abs err) of two outputs as numpy arrays of one type: bit
    for bit (a bf16 or f16 array by its 2-byte patterns), or within
    ``rtol`` (VERIFY_RTOL where a transcendental appears)."""
    from .data import arrays_are_equal
    from .dtypes import cast
    got, want = np.asarray(got).reshape(np.shape(want)), np.asarray(want)
    if got.dtype != want.dtype:
        return False, float("inf")
    bits = (lambda x: x.view(np.uint16)) if got.dtype.itemsize == 2 \
        else (lambda x: x)
    if not rtol and np.array_equal(bits(got), bits(want)):
        return True, 0.0   # at once: a 512^3 float64 copy takes seconds
    a, b = cast(got, np.float64), cast(want, np.float64)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    if rtol:
        return arrays_are_equal(b, a, rtol) and bool(np.isfinite(a).all()), \
            err
    return False, err
