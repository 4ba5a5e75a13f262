"""The JAX package's example scripts (``examples/*.py``) on the port.

Each runs as ``python -m stencilflow_tpu_torch.examples.<name> [--device
cpu]`` (default: the card) and keeps the original's assertions against
the numpy oracle; ``main(device=...)`` takes the original's sizes as
keyword defaults, and returns the lowerings it ran.  The JSON programs
stay in the repository's ``examples/`` directory (``EXAMPLES_DIR``).
"""
import argparse
import os

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples")

NAMES = ("walkthrough", "gray_scott", "shallow_water", "wave_propagation",
         "implicit_diffusion", "inverse_problem", "outofcore_weather",
         "sdfg_roundtrip")


def device_from_argv(doc: str) -> str:
    """The ``--device`` flag of an example's command line."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args().device
