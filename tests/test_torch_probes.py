"""The H100 probes (P1, P4, P7) on the CPU.

The probe kernels (``stencilflow_tpu_torch/csrc/probes/*.cu``) compile
with g++ too (no ``__CUDACC__``): ``sf_alu_host`` and ``sf_copy_host``
run the same per-thread bodies, every thread in turn.  Here they are
built with g++ (``-ffp-contract=off``, no fast math: the IEEE rounding of
nvcc's ``-fmad=false``) and held to the wrappers' plain torch versions at
odd sizes: bit-exact, but for the transcendentals and the fused
multiply-add, within ``alu_ceiling.TOLERANCE`` (relative).  The wrappers
take the plain version only for CPU tensors and raise for a device
tensor when torch sees no GPU.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stencilflow_tpu_torch import probes
from stencilflow_tpu_torch.probes import alu_ceiling, copy_floor, loop_copy


def _gxx_build(name, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    src = tmp_path / f"{name}.cpp"
    src.write_text(probes.source(name))
    so = tmp_path / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-shared", "-fPIC", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def alu_lib(tmp_path_factory):
    lib = _gxx_build("alu", tmp_path_factory.mktemp("alu"))
    lib.sf_alu_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    lib.sf_alu_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def copy_lib(tmp_path_factory):
    lib = _gxx_build("copy", tmp_path_factory.mktemp("copy"))
    lib.sf_copy_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    return lib


def test_op_ids_match_the_kernel():
    """``OPS`` lists the ops in the order of alu.cu's enum."""
    enum = re.search(r"enum \{(.*?)OP_COUNT", probes.source("alu"), re.S)
    ids = [t.strip()[3:].lower() for t in enum.group(1).split(",")
           if t.strip()]
    assert tuple(ids) == alu_ceiling.OPS


@pytest.mark.parametrize("op", alu_ceiling.OPS)
def test_alu_kernel_body_matches_plain(op, alu_lib):
    # expr_jac2d_shift: whole 16 x 16 planes, one a block
    x = alu_ceiling.inputs(512 if op == "expr_jac2d_shift" else 37, "cpu")
    out = torch.empty_like(x)
    for steps in (0, 1, 2):
        rc = alu_lib.sf_alu_host(x.data_ptr(), out.data_ptr(), x.numel(),
                                 alu_ceiling.OPS.index(op), steps, 0)
        assert rc == 0
        want = alu_ceiling.alu_plain(op, x, steps)
        ok, err = alu_ceiling.compare(op, out, want)
        assert ok, f"{op} at {steps} steps: max abs diff {err}"
        assert torch.equal(alu_ceiling.alu(op, x, steps), want)


def test_alu_shared_memory_variant(alu_lib):
    x = alu_ceiling.inputs(19, "cpu")
    out = torch.empty_like(x)
    assert alu_lib.sf_alu_host(x.data_ptr(), out.data_ptr(), 19, 0, 3,
                               1) == 0
    assert torch.equal(out, alu_ceiling.alu_plain("add", x, 3))
    assert alu_lib.sf_alu_host(x.data_ptr(), out.data_ptr(), 19, 2, 3,
                               1) == -1      # add only
    with pytest.raises(ValueError, match="add only"):
        alu_ceiling.alu("mul", x, 1, smem=True)


def test_alu_shift_variant_needs_whole_planes(alu_lib):
    x = alu_ceiling.inputs(300, "cpu")
    out = torch.empty_like(x)
    op = alu_ceiling.OPS.index("expr_jac2d_shift")
    assert alu_lib.sf_alu_host(x.data_ptr(), out.data_ptr(), 300, op, 1,
                               0) == -1
    with pytest.raises(ValueError, match="multiple of 256"):
        alu_ceiling.alu("expr_jac2d_shift", x, 1)


def test_alu_plain_is_the_op_sequence():
    """Spot checks of the plain version against numpy float32."""
    x = alu_ceiling.inputs(5, "cpu")
    xn = x.numpy()
    c, d = xn * np.float32(0.999993), xn * np.float32(1e-7)
    a = xn.copy()
    for u in range(alu_ceiling.UNROLL):
        a = a + (d if u & 1 else c)
    assert np.array_equal(alu_ceiling.alu_plain("add", x, 1).numpy(), a)
    a = xn.copy()
    for u in range(alu_ceiling.UNROLL):
        a = a * c + d
    assert np.array_equal(alu_ceiling.alu_plain("fma", x, 1).numpy(), a)


# float4 tiles need K % 4 == 0 (the wrapper refuses other shapes)
COPY_CASES = [(shape, mode, vec, grid)
              for shape in [(3, 17, 33), (2, 5, 8), (1, 1, 3)]
              for mode, vec, grid in [("flat", 1, 2), ("flat", 4, 3),
                                      ("tile", 1, 2), ("tile", 1, 5),
                                      ("tile", 4, 3)]
              if not (mode == "tile" and vec == 4 and shape[2] % 4)]


@pytest.mark.parametrize("shape,mode,vec,grid", COPY_CASES)
def test_copy_kernel_body_over_odd_shapes(shape, mode, vec, grid,
                                          copy_lib):
    P, J, K = shape
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        -1, 1, shape).astype(np.float32))
    out = torch.full_like(x, float("nan"))
    copy_lib.sf_copy_host(x.data_ptr(), out.data_ptr(), P, J, K,
                          int(mode == "tile"), vec, 7, grid)
    assert torch.equal(out, x)
    assert torch.equal(out, copy_floor.copy_plain(x))
    assert torch.equal(copy_floor.copy(x, mode=mode, vec=vec, grid=grid),
                       x)


def test_loop_copy_plain_ping_pong():
    a = torch.rand(4, 3, 5)
    b = torch.empty_like(a)
    keep = a.clone()
    before = copy_floor.launches
    for iters, unroll in ((1, 1), (3, 2), (2, 4)):
        got = loop_copy.loop(a, b, iters, unroll)
        assert torch.equal(got, keep)
        assert got is (a if iters * unroll % 2 == 0 else b)
        plain = loop_copy.loop_plain(a, iters, unroll)
        assert torch.equal(plain, keep) and plain is not a
    assert copy_floor.launches == before      # plain: nothing launched


def test_wrappers_raise_without_a_gpu(monkeypatch):
    """A tensor off the CPU goes to the kernel, never to the plain
    version: without a GPU the wrappers raise, and the probes' entry
    points exit non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.empty(64, device="meta")
    with pytest.raises(RuntimeError, match="no GPU"):
        alu_ceiling.alu("add", x, 1)
    with pytest.raises(RuntimeError, match="no GPU"):
        copy_floor.copy(x.reshape(1, 8, 8))
    with pytest.raises(RuntimeError, match="no GPU"):
        loop_copy.loop(x.reshape(1, 8, 8), torch.empty(1, 8, 8,
                                                       device="meta"), 1, 1)
    for mod in (alu_ceiling, copy_floor, loop_copy):
        assert mod.main([]) == 1


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError):
        alu_ceiling.alu("nope", torch.zeros(3), 1)
    with pytest.raises(ValueError):
        alu_ceiling.alu("add", torch.zeros(2, 3), 1)
    with pytest.raises(ValueError):
        copy_floor.copy(torch.zeros(3, 4))
    with pytest.raises(ValueError):
        copy_floor.copy(torch.zeros(1, 3, 4), out=torch.zeros(1, 3, 5))


def test_summary_of_measured_rows():
    """The readings the hardware model takes from a P1 sweep: the best
    issue rate over the single-kind ops, the shared-memory pass rate,
    fma's instruction count, and per-op costs less the probe's extra
    ops (sinh and cosh scaled from exp)."""
    rate = {"add": 30.0, "fma": 15.0, "fma_fused": 29.0, "div": 3.0,
            "sqrt": 5.0, "exp": 10.0, "sin": 1.0, "cos": 1.0, "tan": 1.5,
            "tanh": 6.0, "log": 7.5, "select": 15.0, "add_smem": 3.0}
    rows = [{"op": op, "ops_per_s": r,
             "issues_per_s": r * alu_ceiling.INSTRUCTIONS[op]
             if op in alu_ceiling.INSTRUCTIONS else None,
             "vs_add": 30.0 / r} for op, r in rate.items()]
    s = alu_ceiling.summary(rows)
    assert s["issue_rate"] == 30.0 and s["smem_pass_rate"] == 3.0
    assert s["fma_instructions"] == 2.0
    c = s["op_costs"]
    assert c["div"] == 10.0 and c["exp"] == 3.0 and c["cond"] == 1.0
    assert c["tan"] == 19.0 and c["log"] == 3.0
    assert c["sinh"] == c["cosh"] == 8.0
    assert os.path.isfile(os.path.join(probes.CSRC, "alu.cu"))
