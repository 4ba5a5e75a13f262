"""Array I/O and verification helpers.

Covers the reference's data-loading dialect
(stencilflow/helper.py:162-276): scalar literals, embedded
lists, ``constant:<v>`` / ``random:<lo>,<hi>`` generators, and ``.csv`` /
``.dat`` files, plus the relative-tolerance comparison used for verification.

Copied from ``stencilflow_tpu/data.py`` with no change of meaning: the
port cannot import the JAX package, whose ``__init__`` imports jax.  Values
become an input's dtype through ``dtypes.cast``, so a bfloat16 input
(``dtypes.BFLOAT16``, raw bit patterns) holds the values an ml_dtypes
array would: numbers round to float32, then to bf16.  A bf16 ``.csv``
parses as float64 first (numpy's ``genfromtxt`` cannot parse into a
record type; the JAX package's loader raises TypeError there).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np

from . import config
from .dtypes import BFLOAT16, cast
from .ir import InputSpec, Program


def load_array(spec: InputSpec, dimensions: Sequence[int],
               prefix: Optional[str] = None,
               rng: Optional[np.random.Generator] = None):
    """Materialize one program input as a numpy array (or python scalar)."""
    data = spec.data
    dtype = np.dtype(spec.dtype)
    shape = spec.shape(dimensions)
    if isinstance(data, str):
        m = re.match(r"([^:]+):(.+)", data)
        if m and m.group(1) in ("constant", "random"):
            if m.group(1) == "constant":
                val = float(m.group(2))
                if spec.is_scalar:
                    return _scalar(val, dtype)
                if dtype == BFLOAT16:
                    return cast(np.full(shape, val), dtype)
                return np.full(shape, val, dtype=dtype)
            lo, hi = (float(x) for x in m.group(2).split(","))
            rng = rng or np.random.default_rng(0)
            if spec.is_scalar:
                return _scalar(lo + (hi - lo) * rng.random(), dtype)
            return cast(lo + (hi - lo) * rng.random(shape), dtype)
        path = data
        if not os.path.isfile(path) and prefix is not None:
            path = os.path.join(prefix, data)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"input file not found: {data}")
        if path.endswith(".csv"):
            arr = cast(np.genfromtxt(
                path, np.float64 if dtype == BFLOAT16 else dtype,
                delimiter=","), dtype)
        elif path.endswith(".dat"):
            arr = np.fromfile(path, dtype)
        else:
            raise ValueError(f"invalid file type: {path}")
        # NB: shape may be () for a file-backed scalar — reshape anyway
        # (raises clearly on a multi-value file; keeps 0-d so backends'
        # scalar fast paths engage)
        return arr.reshape(shape) if shape is not None else arr
    if spec.is_scalar:
        return _scalar(data, dtype)
    arr = cast(data, dtype) if dtype == BFLOAT16 else \
        np.asarray(data, dtype=dtype)
    return arr.reshape(shape)


def _scalar(value, dtype: np.dtype):
    """A scalar input: a numpy scalar, or a 0-d BFLOAT16 array."""
    return cast(value, dtype) if dtype == BFLOAT16 else dtype.type(value)


def load_input_arrays(program: Program,
                      prefix: Optional[str] = None,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Load every program input (reference: helper.load_input_arrays)."""
    if prefix is None and program.path:
        prefix = os.path.dirname(os.path.abspath(program.path))
    rng = np.random.default_rng(seed)
    return {
        name: load_array(spec, program.dimensions, prefix, rng)
        for name, spec in program.inputs.items()
    }


def save_array(arr: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.asarray(arr).tofile(path)


def save_output_arrays(outputs: Dict[str, np.ndarray], output_dir: str) -> None:
    for name, arr in outputs.items():
        save_array(arr, os.path.join(output_dir, name + ".dat"))


def arrays_are_equal(reference, result,
                     tolerance: float = config.VERIFY_RTOL) -> bool:
    """Relative comparison with epsilon-guarded divisor.

    The reference's formula (helper.py:261-276) divides by
    ``max(ref, res) + eps`` *without* abs: for predominantly negative
    outputs the "relative diff" goes negative and ``<= tol`` passes
    vacuously, so verification could report OK on a wrong result.  We
    deliberately deviate and use ``|ref - res| / (max(|ref|, |res|) + eps)``,
    which is sound for any sign (see tests/test_data.py negative-output
    regression).
    """
    reference = cast(reference, np.float64)
    result = cast(result, np.float64)
    if reference.shape != result.shape:
        return False
    denom = (np.maximum(np.abs(reference), np.abs(result))
             + np.finfo(np.float64).eps)
    relative_diff = np.abs(reference - result) / denom
    return bool(np.all(relative_diff <= tolerance))


def prune_halo(arr: np.ndarray, dimensions: Sequence[int],
               halo: int) -> np.ndarray:
    """Cut ``halo`` cells from both ends of every non-degenerate dim
    (reference: run_program.py:203-209, used with shrink BCs)."""
    if halo <= 0:
        return arr
    arr = np.asarray(arr).reshape(tuple(dimensions))
    if any(d > 1 and d - 2 * halo <= 0 for d in arr.shape):
        # an empty core would make every downstream comparison pass
        # vacuously (np.all over zero elements is True)
        raise ValueError(
            f"halo {halo} leaves no interior for dims {tuple(arr.shape)}")
    slices = tuple(
        slice(halo, d - halo) if d > 1 else slice(None) for d in arr.shape)
    return arr[slices]
