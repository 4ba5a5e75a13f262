"""Dtype handling for stencil programs.

Maps the JSON dialect's dtype names onto numpy dtypes, as
``stencilflow_tpu/dtypes.py`` does, and numpy dtypes onto torch dtypes.

``bfloat16`` is not a numpy dtype without ``ml_dtypes``, which the port
does not depend on.  The port's bf16 is ``BFLOAT16``, a 2-byte numpy
dtype of its own (a one-field record, kind "V" as ml_dtypes' bfloat16
is): an array of it carries the raw bf16 bit patterns, so ``.view(
np.uint16)`` gives the same bits as an ml_dtypes array of the same
values, ``.dat`` files hold them as they are, and torch sees the array
as ``torch.bfloat16`` without a conversion.  numpy cannot compute with
it: arithmetic goes through ``to_float32`` (exact) and back through
``cast`` (round to nearest, ties to even, from float32, as ml_dtypes
rounds; wider values and integers pass through float32 first, as
ml_dtypes' casts do).  Never ``astype`` to or from it: numpy would copy
bytes, not values.
"""
from __future__ import annotations

import numpy as np
import torch

BFLOAT16 = np.dtype([("bfloat16", "V2")])
FLOAT16 = np.dtype(np.float16)

_STR_TO_DTYPE = {
    "float16": FLOAT16,
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "bool": np.dtype(np.bool_),
    "bfloat16": BFLOAT16,
}

_DTYPE_TO_STR = {v: k for k, v in _STR_TO_DTYPE.items()}

_NP_TO_TORCH = {
    FLOAT16: torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
    BFLOAT16: torch.bfloat16,
}


def str_to_dtype(name) -> np.dtype:
    """Resolve a dtype name from the program JSON to a numpy dtype."""
    if isinstance(name, np.dtype):
        return name
    if not isinstance(name, str):
        raise TypeError(f"expected dtype string, got {type(name)}")
    try:
        return _STR_TO_DTYPE[name]
    except KeyError:
        raise ValueError(f"unsupported dtype: {name!r}") from None


def dtype_to_str(dtype: np.dtype) -> str:
    return _DTYPE_TO_STR[np.dtype(dtype)]


def is_narrow(dtype) -> bool:
    """bfloat16 or float16: a float that rounds every operation to 2
    bytes."""
    return np.dtype(dtype) in (BFLOAT16, FLOAT16)


def is_floating(dtype: np.dtype) -> bool:
    dtype = np.dtype(dtype)
    return dtype.kind == "f" or dtype == BFLOAT16


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype name)."""
    return _NP_TO_TORCH[np.dtype(dtype)]


def to_numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    for k, v in _NP_TO_TORCH.items():
        if v == dtype:
            return k
    raise ValueError(f"no numpy dtype for {dtype}")


# -- bfloat16 values -----------------------------------------------------------

def _bf16_bits(f32: np.ndarray) -> np.ndarray:
    """uint16 bits of float32 values rounded to bf16 (to nearest, ties to
    even); a NaN becomes the quiet NaN of its sign, as in ml_dtypes."""
    f32 = np.asarray(f32, np.float32)
    u = np.ascontiguousarray(f32).view(np.uint32).reshape(f32.shape)
    r = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
         >> np.uint32(16)).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        r = np.where(nan, np.where(u >> np.uint32(31), np.uint16(0xFFC0),
                                   np.uint16(0x7FC0)), r)
    return r


def _as_float32(x) -> np.ndarray:
    """Values as float32, the way ml_dtypes' casts to bf16 take them
    (float64 and integers round to float32 first)."""
    a = np.asarray(x)
    if a.dtype == BFLOAT16:
        return to_float32(a)
    with np.errstate(over="ignore", invalid="ignore"):
        return a.astype(np.float32)


def round_bf16(x) -> np.ndarray:
    """``x`` rounded to bf16, as float32 values (same shape)."""
    return to_float32(_bf16_bits(_as_float32(x)).view(BFLOAT16))


def to_float32(arr) -> np.ndarray:
    """A BFLOAT16 array's values as float32 (exact)."""
    a = np.asarray(arr)
    if a.dtype != BFLOAT16:
        raise TypeError(f"expected a bfloat16 array, got {a.dtype}")
    bits = np.ascontiguousarray(a).view(np.uint16).reshape(a.shape)
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def cast(x, dtype) -> np.ndarray:
    """``x`` (array, scalar or list, of any type) as an array of
    ``dtype`` with the oracle's value semantics: to bf16 through
    float32, from bf16 through its float32 value."""
    dtype = np.dtype(dtype)
    a = np.asarray(x)
    if dtype == BFLOAT16:
        if a.dtype == BFLOAT16:
            return a
        return _bf16_bits(_as_float32(a)).view(BFLOAT16)
    if a.dtype == BFLOAT16:
        a = to_float32(a)
    with np.errstate(over="ignore", invalid="ignore"):
        return a.astype(dtype)


def scalar(value, dtype):
    """``value`` as a numpy scalar of ``dtype`` (for bf16: the float32
    scalar of the rounded value)."""
    dtype = np.dtype(dtype)
    if dtype == BFLOAT16:
        return round_bf16(np.float64(value))[()]
    return dtype.type(value)


def to_torch(x, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor of its own type (bf16 bits
    reinterpreted, not converted); a tensor as it is."""
    if torch.is_tensor(x):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype == BFLOAT16:
        bits = np.ascontiguousarray(a).view(np.int16).reshape(a.shape)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(a)
    return t if device is None else t.to(device)


def from_numpy(a) -> torch.Tensor:
    """A CPU tensor over host array ``a`` without a copy (bf16 bits
    viewed as ``torch.bfloat16``); ``a`` must be contiguous."""
    a = np.asarray(a)
    if a.dtype == BFLOAT16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t) -> np.ndarray:
    """A tensor as a numpy array of its own type (bf16 as BFLOAT16)."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()
