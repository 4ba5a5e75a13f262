"""Build and launch the generated CUDA kernels.

Each program's kernel is one CUDA C++ translation unit with a plain C
entry point (codegen.py), compiled with ``nvcc`` into a shared library
and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries are cached by content hash under
``stencilflow_tpu_torch/_build/`` (git-ignored) and per process in memory.

Numerics: ``-fmad=false`` keeps every ``a * b + c`` two rounded ops, as
numpy computes it, and without ``--use_fast_math`` IEEE division and
square root stay correctly rounded, so + - * / sqrt results match the
numpy oracle bit for bit.

The C entry point is ``int sf_launch(const void* const* inputs,
void* const* outputs, const unsigned char* scalars, void* stream)``:
array-input and output device pointers in program order, the scalar
inputs packed into 8-byte slots (``scalar_blob``), and the CUDA stream.
It returns ``cudaGetLastError()`` after the launch.  The local stream
kernel (K4) has ``int sf_local_launch(inputs, outputs, scalars, int
origin_i, stream)`` instead: the chunk's global origin is a launch
argument, so one build serves every chunk.  K4 on one shard of a mesh
has ``int sf_shard_launch(inputs, outputs, scalars, int origin_i, int
origin_j, int origin_k, stream)``: one build serves every shard.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ir
from ..dtypes import cast, is_narrow, to_numpy

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# (library name, seconds) of every nvcc run in this process
build_log: List[tuple] = []
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or NVCC)")


def _digest(source: str) -> str:
    return hashlib.sha256(
        (source + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:24]


def library_path(source: str, name: str) -> str:
    """Where ``load_library`` keeps the library built from ``source``."""
    return os.path.join(BUILD_DIR, f"{name}_{_digest(source)}.so")


def load_library(source: str, name: str) -> ctypes.CDLL:
    """Compile ``source`` (cached by content hash) and load it."""
    digest = _digest(source)
    if digest in _loaded:
        return _loaded[digest]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = library_path(source, name)
    if not os.path.isfile(so_path):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(source)
            tmp_so = os.path.join(tmp, "lib.so")
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp_so,
                                   cu], capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp_so, so_path)
        build_log.append((name, time.perf_counter() - t0))
    lib = ctypes.CDLL(so_path)
    vp = ctypes.c_void_p
    for entry, args in (("sf_launch", [vp] * 4),
                        ("sf_local_launch", [vp] * 3 + [ctypes.c_int, vp]),
                        ("sf_shard_launch",
                         [vp] * 3 + [ctypes.c_int] * 3 + [vp])):
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = args
            getattr(lib, entry).restype = ctypes.c_int
    _loaded[digest] = lib
    return lib


def load_libraries(items) -> List[ctypes.CDLL]:
    """``load_library`` for every ``(source, name)`` in ``items``, one nvcc
    process per source, as many at once as there are CPUs."""
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
        return list(ex.map(lambda item: load_library(*item), items))


def scalar_blob(program: ir.Program, inputs) -> np.ndarray:
    """The scalar inputs, each in its own 8-byte slot, in program order
    (a narrow float as the float32 value the kernels compute with)."""
    names = [n for n, s in program.inputs.items() if s.is_scalar]
    blob = np.zeros(8 * max(1, len(names)), np.uint8)
    for i, n in enumerate(names):
        dt = np.dtype(program.inputs[n].dtype)
        v = to_numpy(inputs[n])
        if is_narrow(dt):
            raw = cast(cast(v, dt), np.float32).tobytes()
        else:
            raw = np.asarray(v, dt).tobytes()
        blob[8 * i:8 * i + len(raw)] = np.frombuffer(raw, np.uint8)
    return blob


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors])


def launch(lib: ctypes.CDLL, program: ir.Program, inputs: Dict[str, object],
           arrays: List[torch.Tensor], outputs: List[torch.Tensor],
           origin_i: Optional[int] = None,
           origin_jk: Optional[tuple] = None) -> None:
    """Launch ``lib``'s kernel on the current stream; raise on a refused
    launch.  ``arrays``/``outputs`` are checked, contiguous CUDA tensors in
    program order; ``origin_i`` goes to a local kernel's
    ``sf_local_launch``, with ``origin_jk`` to a shard's
    ``sf_shard_launch``."""
    blob = scalar_blob(program, inputs)
    device = outputs[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    in_ptrs, out_ptrs = _ptrs(arrays), _ptrs(outputs)
    with torch.cuda.device(device):
        if origin_i is None:
            rc = lib.sf_launch(ctypes.addressof(in_ptrs),
                               ctypes.addressof(out_ptrs),
                               blob.ctypes.data, stream)
        elif origin_jk is not None:
            rc = lib.sf_shard_launch(ctypes.addressof(in_ptrs),
                                     ctypes.addressof(out_ptrs),
                                     blob.ctypes.data, int(origin_i),
                                     int(origin_jk[0]), int(origin_jk[1]),
                                     stream)
        else:
            rc = lib.sf_local_launch(ctypes.addressof(in_ptrs),
                                     ctypes.addressof(out_ptrs),
                                     blob.ctypes.data, int(origin_i),
                                     stream)
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {rc}")
