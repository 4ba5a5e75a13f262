"""The programs the solver entry points (iterate, grad, solve) are
measured on at full width: ``chip_smoke.py``'s solvers phase and
``deep_time.py --cells solvers`` build them from here.

* ``gray_scott``: the coupled nonlinear two-field system of
  ``examples/gray_scott.py`` (``build_program``), rebuilt in the port's
  terms: forward Euler of u' = u + Du lap(u) - u v^2 + F (1 - u) and
  v' = v + Dv lap(v) + u v^2 - (F + K) v on an n x n plane with copy
  (zero-flux) walls and the example's seeded square;
* ``implicit_diffusion``: the backward-Euler operator y = x - dt lap(x)
  on an n^3 grid with constant BC 0 (SPD: CG);
* ``upwind``: y = x - c (x - x[k-1]) on an n^3 grid (not symmetric:
  CGNR).
"""
from __future__ import annotations

import numpy as np

from . import ir
from .frontend.parser import parse_program

DU, DV = 0.16, 0.08       # the example's diffusion rates
F, K = 0.0545, 0.062      # its feed / kill rates
GRAY_SCOTT_FEED = {"u": "u1", "v": "v1"}


def gray_scott(n: int) -> ir.Program:
    def lap(f):
        return (f"({f}[j-1, k] + {f}[j+1, k] + {f}[j, k-1] + "
                f"{f}[j, k+1] - 4.0 * {f}[j, k])")

    bc = {t: {"type": "copy"} for t in ("u", "v")}
    rng = np.random.default_rng(7)
    u0 = np.ones((n, n), np.float32)
    v0 = np.zeros((n, n), np.float32)
    s = slice(n // 2 - n // 12, n // 2 + n // 12)
    u0[s, s] = 0.50
    v0[s, s] = 0.25
    u0 += (0.02 * rng.random((n, n))).astype(np.float32)
    return parse_program({
        "inputs": {
            "u": {"data": u0, "data_type": "float32"},
            "v": {"data": v0, "data_type": "float32"},
        },
        "outputs": ["u1", "v1"],
        "dimensions": [n, n],
        "program": {
            "u1": {"computation_string":
                   f"u1 = u[j, k] + {DU} * {lap('u')} "
                   f"- u[j, k] * v[j, k] * v[j, k] "
                   f"+ {F} * (1.0 - u[j, k])",
                   "boundary_conditions": bc, "data_type": "float32"},
            "v1": {"computation_string":
                   f"v1 = v[j, k] + {DV} * {lap('v')} "
                   f"+ u[j, k] * v[j, k] * v[j, k] "
                   f"- {F + K} * v[j, k]",
                   "boundary_conditions": bc, "data_type": "float32"},
        },
    }, name="gray_scott")


def _operator(n: int, body: str, name: str,
              dtype: str = "float32") -> ir.Program:
    return parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": dtype}},
        "outputs": ["y"], "dimensions": [n, n, n],
        "program": {"y": {
            "computation_string": body,
            "boundary_conditions": {"x": {"type": "constant",
                                          "value": 0.0}},
            "data_type": dtype}}}, name=name)


def implicit_diffusion(n: int, dt: float = 0.3,
                       dtype: str = "float32") -> ir.Program:
    """``dtype``: the field's type (the program typed float16, say)."""
    return _operator(
        n, f"y = x[i, j, k] - {dt} * (x[i-1, j, k] + x[i+1, j, k] + "
           "x[i, j-1, k] + x[i, j+1, k] + x[i, j, k-1] + x[i, j, k+1] "
           "- 6.0 * x[i, j, k])",
        f"implicit_diffusion_{n}" + ("" if dtype == "float32" else
                                     f"_{dtype}"), dtype)


def upwind(n: int, c: float = 0.4) -> ir.Program:
    return _operator(n, f"y = x[i, j, k] - {c} * (x[i, j, k] - "
                        "x[i, j, k-1])", f"upwind_{n}")
