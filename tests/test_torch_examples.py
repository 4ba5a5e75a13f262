"""The JAX package's example scripts, ported (``stencilflow_tpu_torch/
examples/``), on the CPU at reduced sizes.

Each ``main(device="cpu")`` runs the plain versions of its lowerings and
its own assertions against the numpy oracle (the originals' tolerances:
exact for the simulator, rtol 1e-4 / atol 1e-5 for fused time-stepping
against oracle steps, 1e-5 absolute for the stream lowering and the
adjoint against autograd, the refocusing and recovery thresholds).  The
sizes are cut where the original's size would take seconds on the CPU,
to sizes at which each assertion still holds.  On the card the same
scripts run at their own sizes (``tests/test_torch_cuda.py``).
"""
import importlib

import pytest

from stencilflow_tpu_torch.examples import NAMES

REDUCED = {
    "walkthrough": dict(size=18),
    "gray_scott": dict(n=36, steps=100),
    "shallow_water": dict(n=16, steps=20),
    "wave_propagation": dict(n=24, steps=24),
    "implicit_diffusion": dict(n=24),
    "inverse_problem": dict(n=32, iters=200),
    "outofcore_weather": dict(size=(8, 16, 16)),
    "sdfg_roundtrip": dict(shape=[4, 12, 12]),
}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_its_assertions(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"stencilflow_tpu_torch.examples.{name}")
    lowerings = module.main(device="cpu", **REDUCED[name])
    assert lowerings and all(isinstance(n, str) for n in lowerings)


def test_examples_refuse_a_missing_card(monkeypatch):
    """An example asked for the card without one raises; it does not fall
    back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(
        "stencilflow_tpu_torch.examples.implicit_diffusion")
    with pytest.raises(RuntimeError, match="no GPU"):
        module.main(n=8)
