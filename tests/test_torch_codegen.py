"""The generated per-cell math, compiled with g++, against the numpy oracle.

codegen.py emits the same ``SF_HD`` stage functions into the CUDA kernels
and into a host loop nest over the whole domain (``host_source``).  The
host loop nest compiles with g++ on any CPU machine, so it carries the
check where there is no nvcc or GPU: the
generated typed math and boundary-condition reads must equal the oracle
bit for bit (np.array_equal, NaN == NaN) on random chains in float32,
float64 and int32, with constant, copy and shrink BCs, and on mixed-dtype
programs.  The kernel skeletons around the stage functions are checked
for their launch contract here and for their results on the card.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import codegen, overlap, panel
from stencilflow_tpu_torch.backend.build import NVCC_FLAGS, scalar_blob
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    return gxx


def run_host(program, inputs, tmp_path):
    """Compile ``host_source`` with g++ and run it on ``inputs``."""
    an = port.ChainAnalysis.run(program)
    src = codegen.host_source(program, an)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_host_run.argtypes = [ctypes.c_void_p] * 3
    arrays = [np.ascontiguousarray(inputs[n])
              for n, s in program.inputs.items() if not s.is_scalar]
    order = an.graph.kernel_order
    fields = [np.empty(program.dimensions, program.kernels[k].dtype)
              for k in order]
    ip = (ctypes.c_void_p * max(1, len(arrays)))(
        *[a.ctypes.data for a in arrays])
    fp = (ctypes.c_void_p * len(fields))(*[f.ctypes.data for f in fields])
    blob = scalar_blob(program, inputs)
    lib.sf_host_run(ctypes.addressof(ip), ctypes.addressof(fp),
                    blob.ctypes.data)
    return {k: f.reshape(program.raw_dimensions)
            for k, f in zip(order, fields) if k in program.outputs}


VARIANTS = {
    "f32": {},
    "f64": {"data_type": "float64"},
    "i32": {"data_type": "int32", "data": "random:-20,20"},
    "shrink": {"bc_kinds": ("constant", "copy", "shrink")},
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_host_math_matches_oracle(variant, seed, tmp_path):
    _gxx()
    spec = random_program(np.random.default_rng(200 + seed),
                          **VARIANTS[variant])
    p = port.parse_program(spec)
    inputs = port.load_input_arrays(p, seed=seed)
    want = port.run_interpreter(p, inputs)
    got = run_host(p, inputs, tmp_path)
    for o in want:
        assert got[o].dtype == want[o].dtype
        np.testing.assert_array_equal(got[o], want[o])


MIXED = {
    # int32 x float32 computes in float32 (2**24 + 1 rounds to 2**24)
    "int_times_float": ("n[i, j, k] * x[i, j, k] + min(n[i, j, k], x[i, j, k])",
                        "float32"),
    # int8 wraparound, compares, selects and abs on ints
    "int8_wrap": ("abs(b[i, j, k] * b[i, j+1, k] - b[i, j, k-1]) "
                  "if b[i, j, k] > b[i+1, j, k] else -b[i, j, k]", "int8"),
    # true division of ints is float64; f64 result cast to int32
    "int_div": ("n[i, j, k] / (n[i-1, j, k] + 3.0)", "int32"),
    "bool_logic": ("(x[i, j, k] > 0.5) and (x[i, j+1, k] < 0.9) or "
                   "(x[i, j, k-1] > x[i, j, k])", "bool"),
}


@pytest.mark.parametrize("name", sorted(MIXED))
def test_host_math_mixed_dtypes(name, tmp_path):
    _gxx()
    expr, dt = MIXED[name]
    spec = {
        "inputs": {"n": {"data": "random:-40000000,40000000",
                         "data_type": "int32"},
                   "x": {"data": "random:0,1", "data_type": "float32"},
                   "b": {"data": "random:-120,120", "data_type": "int8"}},
        "outputs": ["s"], "dimensions": [4, 5, 6],
        "program": {"s": {"computation_string": f"s = {expr}",
                          "boundary_conditions": {
                              "n": {"type": "copy"},
                              "x": {"type": "constant", "value": 0.25},
                              "b": {"type": "constant", "value": 3}},
                          "data_type": dt}}}
    p = port.parse_program(spec)
    inputs = port.load_input_arrays(p, seed=5)
    inputs["n"][0, 0, 0] = 2 ** 24 + 1
    want = port.run_interpreter(p, inputs)
    got = run_host(p, inputs, tmp_path)
    np.testing.assert_array_equal(got["s"], want["s"])


def test_host_math_transcendentals(tmp_path):
    """sin/exp/sqrt/log go through libm on the host and CUDA's math
    library on the card: within VERIFY_RTOL of numpy, not bit-exact."""
    _gxx()
    spec = {"inputs": {"x": {"data": "random:0.1,2", "data_type": "float32"}},
            "outputs": ["s"], "dimensions": [4, 4, 8],
            "program": {"s": {"computation_string":
                              "s = sin(x[i, j, k]) + exp(x[i, j+1, k]) * "
                              "sqrt(x[i, j, k]) - log(x[i, j, k-1] + 1.0)",
                              "data_type": "float32"}}}
    p = port.parse_program(spec)
    inputs = port.load_input_arrays(p, seed=1)
    want = port.run_interpreter(p, inputs)
    got = run_host(p, inputs, tmp_path)
    assert port.arrays_are_equal(want["s"], got["s"], port.VERIFY_RTOL)


def test_kernel_sources_contract():
    """Both skeletons: one C entry point that raises the shared-memory
    limit, launches on the given stream and returns cudaGetLastError;
    compiled without fast math and with FMA contraction off."""
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(16, 16, 16), shape="hotspot"))
    an = port.ChainAnalysis.run(p)
    for src in (codegen.panel_source(p, an, panel.PanelPlan.build(an)),
                codegen.overlap_source(p, an,
                                       overlap.OverlapPlan.build(an))):
        assert src.count('extern "C" int sf_launch(') == 1
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
        assert "(cudaStream_t)stream" in src
        assert "return (int)cudaGetLastError();" in src
        # barriers: written out, or through the SF_SYNC() macro
        assert "__syncthreads();" in src or (
            "#define SF_SYNC() __syncthreads()" in src
            and "SF_SYNC();" in src)
        assert "#include <torch" not in src
    assert "-fmad=false" in NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert not any("fast_math" in f for f in NVCC_FLAGS)


def test_literals_round_trip():
    for v, dt in ((0.1, np.float32), (-100000.0, np.float32),
                  (1e300, np.float64), (-2 ** 63, np.int64),
                  (True, np.bool_), (float("inf"), np.float32)):
        lit = codegen.literal(np.dtype(dt).type(v), dt)
        assert lit
    assert codegen.literal(np.float32(0.1), np.float32) == \
        f"((float){float(np.float32(0.1)).hex()})"
    assert os.path.basename(codegen.__file__) == "codegen.py"
