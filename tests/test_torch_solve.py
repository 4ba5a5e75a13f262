"""The port's Krylov solvers (solve.py) against the JAX package's and
dense numpy solves, on the CPU.

CG on an SPD implicit-diffusion operator and CGNR (through the port's
own adjoint program) on a nonsymmetric upwind operator solve the
program's equation within the solve tolerance of ``np.linalg.solve``,
in the JAX package's iteration count +- 1; the affine offset (a boundary
constant of 2.5, a source input) moves to the right-hand side; the
out-of-core solvers agree with the in-core ones; the rejections and the
``solve`` subcommand are the reference's.
"""
import itertools
import json

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.solve import make_solver as ref_make_solver

N, DT = 10, 0.3


def _implicit_spec(bc_value=0.0, source=False):
    inputs = {"x": {"data": "constant:0.0", "data_type": "float32"}}
    extra = ""
    if source:
        inputs["s"] = {"data": "random:0,1", "data_type": "float32"}
        extra = " + 0.1 * s[j, k]"
    return {
        "inputs": inputs,
        "outputs": ["y"], "dimensions": [N, N],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] - {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k]){extra}",
            "boundary_conditions": {
                f: {"type": "constant", "value": bc_value}
                for f in inputs},
            "data_type": "float32"}}}


UPWIND = {
    "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
    "outputs": ["y"], "dimensions": [N, N],
    "program": {"y": {
        "computation_string": "y = x[j, k] - 0.4 * (x[j, k] - x[j, k-1])",
        "boundary_conditions": {"x": {"type": "constant", "value": 0.0}},
        "data_type": "float32"}}}


def _dense_operator():
    A = np.zeros((N * N, N * N), np.float32)
    for j, k in itertools.product(range(N), range(N)):
        r = j * N + k
        A[r, r] = 1 + 4 * DT
        for dj, dk in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            jj, kk = j + dj, k + dk
            if 0 <= jj < N and 0 <= kk < N:
                A[r, jj * N + kk] = -DT
    return A


def _both(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                  name=name)


@pytest.mark.parametrize("bc_value,source", [(0.0, False), (2.5, False),
                                             (0.0, True)])
def test_cg_solves_the_program_equation(bc_value, source):
    """fn(x) == rhs: boundary constants and source inputs fold into the
    offset; x within the solve tolerance (2e-4 relative, 3e-5 absolute,
    the reference test's) of the dense solve; JAX's iterations +- 1."""
    a, b = _both(_implicit_spec(bc_value, source), f"impl{bc_value}")
    rhs = np.random.default_rng(0).random((N, N)).astype(np.float32)
    x, info = port.solve_cg(b, rhs, tol=1e-6, device="cpu")
    _rx, rinfo = ref_make_solver(a, tol=1e-6, interpret=True)(rhs)
    assert abs(info["iterations"] - rinfo["iterations"]) <= 1
    assert info["residual"] < 1e-5
    zero = {**port.load_input_arrays(b), "x": np.zeros((N, N), np.float32)}
    c = port.run_interpreter(b, zero)["y"]
    x_ref = np.linalg.solve(_dense_operator(),
                            (rhs - c).ravel()).reshape(N, N)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-4, atol=3e-5)
    y = port.run_interpreter(b, {**port.load_input_arrays(b),
                                 "x": x.numpy()})["y"]
    np.testing.assert_allclose(y, rhs, rtol=2e-4, atol=2e-5)


def test_residual_normalized_by_original_rhs():
    """info['residual'] is |fn(x) - rhs| / |rhs| with a large offset."""
    _a, b = _both(_implicit_spec(bc_value=2.0, source=True), "nrm")
    rhs = np.full((N, N), 5.0, np.float32)
    x, info = port.solve_cg(b, rhs, tol=1e-8, maxiter=500, device="cpu")
    y = port.run_interpreter(b, {**port.load_input_arrays(b),
                                 "x": x.numpy()})["y"]
    true_rel = np.linalg.norm(y - rhs) / np.linalg.norm(rhs)
    assert info["residual"] == pytest.approx(true_rel, rel=0.05, abs=1e-7)


def test_cgnr_nonsymmetric():
    """CGNR through the port's adjoint program: the dense solve within
    1e-3 (the reference test's), JAX's iterations +- 1."""
    a, b = _both(UPWIND, "upwind")
    rhs = np.random.default_rng(1).random((N, N)).astype(np.float32)
    solver = port.make_solver(b, method="cgnr", tol=1e-6, maxiter=3000,
                              device="cpu")
    assert solver.lowering == {"operator": "dense", "transpose": "dense"}
    x, info = solver(rhs)
    _rx, rinfo = ref_make_solver(a, method="cgnr", tol=1e-6, maxiter=3000,
                                 interpret=True)(rhs)
    assert abs(info["iterations"] - rinfo["iterations"]) <= 1
    assert info["residual"] < 1e-4
    A = np.eye(N * N, dtype=np.float32) * 0.6
    for j, k in itertools.product(range(N), range(N)):
        if k > 0:
            A[j * N + k, j * N + k - 1] = 0.4
    x_ref = np.linalg.solve(A, rhs.ravel()).reshape(N, N)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-3, atol=1e-3)


def test_make_solver_reuse_time_stepping():
    """One solver drives implicit steps; diffusion with zero BCs decays."""
    _a, b = _both(_implicit_spec(), "reuse")
    solver = port.make_solver(b, tol=1e-6, device="cpu")
    state = np.random.default_rng(2).random((N, N)).astype(np.float32)
    norms = [float(np.linalg.norm(state))]
    for _ in range(3):
        state, info = solver(state)
        assert info["residual"] < 1e-5
        norms.append(float(np.linalg.norm(state.numpy())))
    assert norms[0] > norms[1] > norms[2] > norms[3]


def _impl3d(nonsym=False):
    body = ("y = x[i,j,k] - 0.4*(x[i,j,k] - x[i,j,k-1])" if nonsym else
            "y = x[i,j,k] - 0.1*(x[i-1,j,k] + x[i+1,j,k] + x[i,j-1,k] + "
            "x[i,j+1,k] + x[i,j,k-1] + x[i,j,k+1] - 6.0*x[i,j,k])")
    return {"inputs": {"x": {"data": "constant:0.0",
                             "data_type": "float32"}},
            "outputs": ["y"], "dimensions": [8, 6, 6],
            "program": {"y": {"computation_string": body,
                              "boundary_conditions": {
                                  "x": {"type": "constant", "value": 0.0}},
                              "data_type": "float32"}}}


@pytest.mark.parametrize("method", ["cg", "cgnr"])
def test_host_chunks_matches_in_core(method):
    """Out-of-core (f64 dots, host vectors) agrees with the in-core solve
    within 10 * tol relative, and the reference's out-of-core solve's
    iterations +- 1."""
    a, b = _both(_impl3d(nonsym=method == "cgnr"), f"hc{method}")
    rhs = np.random.default_rng(3).random((8, 6, 6)).astype(np.float32)
    tol = 1e-6
    xc, info_c = port.make_solver(b, method=method, tol=tol,
                                  host_chunks=2, device="cpu")(rhs)
    xi, _info_i = port.make_solver(b, method=method, tol=tol,
                                   device="cpu")(rhs)
    assert isinstance(xc, np.ndarray)
    assert info_c["residual"] < 1e-4
    assert np.linalg.norm(xc - xi.numpy()) <= \
        10 * tol * np.linalg.norm(xc)
    _rx, rinfo = ref_make_solver(a, method=method, tol=tol, host_chunks=2,
                                 interpret=True)(rhs)
    assert abs(info_c["iterations"] - rinfo["iterations"]) <= 1


def test_rejections():
    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(4, 8, 8), shape="hdiff"), name="slv_nl")
    with pytest.raises(ValueError, match="not affine"):
        port.solve_cg(p, np.zeros((4, 8, 8), np.float32), field="a",
                      device="cpu")
    p2 = port.parse_program(_implicit_spec(), name="rej")
    with pytest.raises(ValueError, match="unknown method"):
        port.make_solver(p2, method="qmr", device="cpu")
    with pytest.raises(ValueError, match="is CG"):
        port.solve_cg(p2, np.zeros((N, N), np.float32), method="cgnr",
                      device="cpu")
    with pytest.raises(ValueError, match="not a program input"):
        port.make_solver(p2, field="zz", device="cpu")


@pytest.mark.parametrize("extra,rc", [([], 0), (["--maxiter", "1"], 1)])
def test_cli_solve(tmp_path, capsys, extra, rc):
    """The reference's line and exit code (0 iff the residual is at most
    100 * tol); x within the solve tolerance of the reference's."""
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    spec = _impl3d()
    path = tmp_path / "p.json"
    path.write_text(json.dumps(spec))
    argv = ["solve", str(path), "--rhs", "random:0,1", "--host-chunks",
            "2", "--emulation"] + extra
    assert ref_main(argv + ["-o", str(tmp_path / "ref.dat")]) == rc
    want = capsys.readouterr().out
    assert main(argv + ["-o", str(tmp_path / "x.dat")]) == rc
    got = capsys.readouterr().out
    assert got.split(";")[0] == want.split(";")[0]
    assert got.startswith("converged in ")
    x = np.fromfile(tmp_path / "x.dat", np.float32)
    x_ref = np.fromfile(tmp_path / "ref.dat", np.float32)
    if rc == 0:
        np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-5)
