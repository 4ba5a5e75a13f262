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
stream kernel's local mode (K4).  On those lowerings: time-stepping with
checkpoints, its loop replayed from CUDA graphs (iterate.py), adjoints
and gradients (grad.py) and CG / CGNR solves (solve.py).  The
cycle-accurate dataflow simulator (sim/, on the host) cross-checks the
kernels' outputs (``run --run-simulation``).  ``autotune.py`` times
every applicable lowering on the card and caches the winner
(``compile_chain_autotuned``, ``run --backend autotuned``).  The
measurement path:
the analytic report on the H100 hardware model (report.py, ``cli
report``), the bench (bench.py) and the probes that measure the model's
constants (probes/).  Programs also come from traced Python functions
(frontend/trace.py), serialized DaCe SDFGs (frontend/sdfg_import.py and
frontend/mapnest.py) and ordered op lists (frontend/canonicalize.py),
whose passes the ``canonicalize`` subcommand runs; ``compile`` writes and
builds the CUDA C++ of a program's route, and examples/ holds the JAX
package's example scripts on the port.
"""

__version__ = "0.1.0"

from .config import ITERATORS, JUNK_VAL, VERIFY_RTOL
from .dtypes import dtype_to_str, str_to_dtype
from .ir import (Access, Assign, BCKind, BinOp, BoolOp, BoundaryCondition,
                 Call, Compare, Const, InputSpec, KernelSpec, Program, Ref,
                 Select, UnaryOp)
from .frontend.parser import StencilSyntaxError, parse_program
from .frontend.chain import ChainGraph, CycleError
from .frontend.analysis import ChainAnalysis, flatten_index
from .frontend.canonicalize import (canonicalize, nest_dimension,
                                    program_from_op_list, version_program)
from .frontend.trace import trace_program
from .frontend.export import program_to_json
from .grad import (adjoint_program, fast_value_and_grad, grad,
                   value_and_grad)
from .solve import make_solver, solve_cg, solve_cgnr
from .iterate import compose_iterations, iterate, make_step
from .outofcore import compile_chunked_chain, run_chunked
# only the compile entry point: exporting autotune.autotune here would
# shadow the stencilflow_tpu_torch.autotune module attribute
from .autotune import compile_chain_autotuned
from .interpreter import ChainInterpreter, run_interpreter
from .data import (arrays_are_equal, load_array, load_input_arrays,
                   prune_halo, save_array, save_output_arrays)

__all__ = [
    "ITERATORS", "JUNK_VAL", "VERIFY_RTOL",
    "str_to_dtype", "dtype_to_str",
    "Access", "Assign", "BCKind", "BinOp", "BoolOp", "BoundaryCondition",
    "Call", "Compare", "Const", "InputSpec", "KernelSpec", "Program", "Ref",
    "Select", "UnaryOp",
    "parse_program", "StencilSyntaxError", "ChainGraph", "CycleError",
    "ChainAnalysis", "flatten_index",
    "canonicalize", "nest_dimension", "program_from_op_list",
    "version_program",
    "trace_program", "program_to_json",
    "compose_iterations", "iterate", "make_step",
    "adjoint_program", "fast_value_and_grad", "grad", "value_and_grad",
    "make_solver", "solve_cg", "solve_cgnr",
    "compile_chunked_chain", "run_chunked", "compile_chain_autotuned",
    "ChainInterpreter", "run_interpreter",
    "arrays_are_equal", "load_array", "load_input_arrays", "prune_halo",
    "save_array", "save_output_arrays",
]
