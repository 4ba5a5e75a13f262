"""Inverse problem: recover an initial condition through the solver.

Given only the OUTPUT of an 8-step diffusion chain applied to an unknown
initial field, reconstruct that field by gradient descent through the
whole chain (``sft.fast_value_and_grad`` + Adam) — 4D-Var-style data
assimilation in ~30 lines, impossible with the reference's generated
OpenCL/HLS pipelines.

Port of ``examples/inverse_problem.py``: the forward and adjoint chains
on ``device``'s kernels, and ``torch.optim.Adam`` in the place of optax's
Adam (the same update and defaults: betas 0.9 / 0.999, eps 1e-8).

    python -m stencilflow_tpu_torch.examples.inverse_problem [--device cpu]
"""
import numpy as np
import torch

import stencilflow_tpu_torch as sft
from stencilflow_tpu_torch.synthesize import jacobi

N, STEPS = 48, 8


def main(device="cuda", n: int = N, iters: int = 300):
    program = sft.parse_program(jacobi(2, n, iterations=STEPS),
                                name="inverse")
    out_name = program.outputs[0]

    # ground truth: two gaussian bumps; observed = chain(truth)
    y, x = np.mgrid[:n, :n]
    truth = (np.exp(-((y - 14 * n / 48) ** 2 + (x - 14 * n / 48) ** 2)
                    / (18.0 * (n / 48) ** 2))
             + 0.7 * np.exp(-((y - 33 * n / 48) ** 2
                              + (x - 30 * n / 48) ** 2)
                            / (30.0 * (n / 48) ** 2))
             ).astype(np.float32)
    observed = torch.as_tensor(
        sft.run_interpreter(program, {"a": truth})[out_name],
        device=device)

    # both passes on the kernels (sft.value_and_grad is the general
    # path for non-affine programs)
    f = sft.fast_value_and_grad(
        program, loss=lambda o: ((o[out_name] - observed) ** 2).mean(),
        device=device)

    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    opt = torch.optim.Adam([a], lr=0.05)
    for i in range(iters):
        val, grads = f({"a": a})
        a.grad = grads["a"]
        opt.step()
        if i % 100 == 0:
            print(f"iter {i}: data misfit {float(val):.3e}")

    rec = a.cpu().numpy()
    err = float(np.abs(rec - truth).max())
    corr = float(np.corrcoef(rec.ravel(), truth.ravel())[0, 1])
    print(f"recovered initial condition ({f.lowering['forward']} / "
          f"{f.lowering['adjoint']}): max|err|={err:.3f}, correlation "
          f"{corr:.4f}")
    assert corr > 0.98
    print("OK")
    return [f.lowering["forward"], f.lowering["adjoint"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))
