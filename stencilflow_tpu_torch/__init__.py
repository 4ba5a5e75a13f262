"""stencilflow_tpu_torch — the PyTorch + CUDA port of stencilflow_tpu.

The same JSON program dialect, analyses and numpy oracle as the JAX
package (copied, not imported: ``import stencilflow_tpu`` loads jax),
lowered to torch tensors on one NVIDIA Hopper GPU.  The ``run`` main path —
parse, analyse, ``backend.compile_chain_best``, execute, verify — goes
through CUDA C++ kernels generated per program from the IR: the stream
kernel (backend/stream.py) for wide affine chains, the group streamer
(backend/group.py) for deep 2-D chains rotated to rows, the overlap
streamer (backend/overlap.py) for shallow chains and the panel streamer
(backend/panel.py) for deep ones, with the whole-domain torch evaluator
(backend/dense.py) as the fallback and the CPU path.  Out-of-core runs
(outofcore.py, ``run --host-chunks N``) stream host i-chunks through the
stream kernel's local mode (K4).
"""

__version__ = "0.1.0"

from .config import ITERATORS, JUNK_VAL, VERIFY_RTOL
from .dtypes import dtype_to_str, str_to_dtype
from .ir import (Access, Assign, BCKind, BinOp, BoolOp, BoundaryCondition,
                 Call, Compare, Const, InputSpec, KernelSpec, Program, Ref,
                 Select, UnaryOp)
from .frontend.parser import StencilSyntaxError, parse_program
from .frontend.chain import ChainGraph, CycleError
from .frontend.analysis import ChainAnalysis
from .interpreter import ChainInterpreter, run_interpreter
from .data import (arrays_are_equal, load_input_arrays, prune_halo,
                   save_output_arrays)

__all__ = [
    "ITERATORS", "JUNK_VAL", "VERIFY_RTOL",
    "str_to_dtype", "dtype_to_str",
    "Access", "Assign", "BCKind", "BinOp", "BoolOp", "BoundaryCondition",
    "Call", "Compare", "Const", "InputSpec", "KernelSpec", "Program", "Ref",
    "Select", "UnaryOp",
    "parse_program", "StencilSyntaxError", "ChainGraph", "CycleError",
    "ChainAnalysis", "ChainInterpreter", "run_interpreter",
    "arrays_are_equal", "load_input_arrays", "prune_halo",
    "save_output_arrays",
]
