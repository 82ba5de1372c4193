"""Scalar type system (counterpart of kfunca_tpu/core/dtype.py).

kfunca's own promotion table and accumulation rule, over torch dtypes.
Neither is torch's: `promote` gives bf16 + fp16 -> bf16 and uint8 + int8 ->
int8 (torch.promote_types gives float32 and int16), and `accumulate_type`
computes 16-bit floats in fp32 and every integer type in int64.

Enum order matters: the reference promotion rule is "float beats int, wider
enum wins among floats / among signed ints / among unsigned ints, signed
beats unsigned".  BFloat16 > Half in this ordering.

`cast` is the one conversion every store goes through.  It follows XLA's
convert, which the JAX package returns: a float stored into an integer type
saturates at the type's range and NaN becomes 0 (torch leaves both
undefined); integer narrowing wraps, as in both frameworks.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class ScalarType(enum.IntEnum):
    Bool = 0
    Byte = 1  # uint8
    Char = 2  # int8
    Short = 3  # int16
    Int = 4  # int32
    Long = 5  # int64
    Half = 6  # float16
    BFloat16 = 7
    Float = 8  # float32
    Double = 9  # float64
    Undefined = 10


_TORCH_DTYPE = {
    ScalarType.Bool: torch.bool,
    ScalarType.Byte: torch.uint8,
    ScalarType.Char: torch.int8,
    ScalarType.Short: torch.int16,
    ScalarType.Int: torch.int32,
    ScalarType.Long: torch.int64,
    ScalarType.Half: torch.float16,
    ScalarType.BFloat16: torch.bfloat16,
    ScalarType.Float: torch.float32,
    ScalarType.Double: torch.float64,
}
_FROM_TORCH = {v: k for k, v in _TORCH_DTYPE.items()}

_ELEMENT_SIZE = {
    ScalarType.Bool: 1,
    ScalarType.Byte: 1,
    ScalarType.Char: 1,
    ScalarType.Short: 2,
    ScalarType.Int: 4,
    ScalarType.Long: 8,
    ScalarType.Half: 2,
    ScalarType.BFloat16: 2,
    ScalarType.Float: 4,
    ScalarType.Double: 8,
}

# numpy dtype name -> ScalarType (from_numpy ingest table).  "bfloat16" is
# the name of ml_dtypes' type, which the JAX package hands out; it is read
# by name, so the port needs no ml_dtypes.
_NUMPY_TO_SCALAR = {
    "bool": ScalarType.Bool,
    "uint8": ScalarType.Byte,
    "int8": ScalarType.Char,
    "int16": ScalarType.Short,
    "int32": ScalarType.Int,
    "int64": ScalarType.Long,
    "float16": ScalarType.Half,
    "bfloat16": ScalarType.BFloat16,
    "float32": ScalarType.Float,
    "float64": ScalarType.Double,
}


def from_numpy_dtype(np_dtype) -> ScalarType:
    name = np.dtype(np_dtype).name
    try:
        return _NUMPY_TO_SCALAR[name]
    except KeyError:
        raise TypeError(f"Unsupported numpy dtype in from_numpy(): {np_dtype}")


def to_torch(dtype: ScalarType) -> torch.dtype:
    return _TORCH_DTYPE[dtype]


def from_torch(dtype: torch.dtype) -> ScalarType:
    try:
        return _FROM_TORCH[dtype]
    except KeyError:
        raise TypeError(f"Unsupported torch dtype: {dtype}")


def element_size(dtype: ScalarType) -> int:
    return _ELEMENT_SIZE[dtype]


def is_floating_type(t: ScalarType) -> bool:
    return t in (ScalarType.Half, ScalarType.BFloat16, ScalarType.Float, ScalarType.Double)


def is_unsigned_int_type(t: ScalarType) -> bool:
    return t == ScalarType.Byte


def is_integral_type(t: ScalarType) -> bool:
    return t in (
        ScalarType.Bool,
        ScalarType.Byte,
        ScalarType.Char,
        ScalarType.Short,
        ScalarType.Int,
        ScalarType.Long,
    )


def promote(a: ScalarType, b: ScalarType) -> ScalarType:
    """Two-operand type promotion (reference tensor_iterator.cpp:32-44).

    float beats int; among floats/signed-ints/unsigned-ints the wider enum
    wins; signed beats unsigned.
    """
    if a == ScalarType.Undefined:
        return b
    if b == ScalarType.Undefined:
        return a
    if is_floating_type(a) and is_floating_type(b):
        return a if a >= b else b
    if is_floating_type(a) or is_floating_type(b):
        return a if is_floating_type(a) else b
    if is_unsigned_int_type(a) and is_unsigned_int_type(b):
        return a if a >= b else b
    if is_unsigned_int_type(a) or is_unsigned_int_type(b):
        return b if is_unsigned_int_type(a) else a
    return a if a >= b else b


def accumulate_type(t: ScalarType) -> ScalarType:
    """Accumulation dtype used for arithmetic (reference accumulate_type.h:17-42).

    half/bf16 math runs in fp32; integer math accumulates in int64.
    """
    if t in (ScalarType.Half, ScalarType.BFloat16, ScalarType.Float):
        return ScalarType.Float
    if t == ScalarType.Double:
        return ScalarType.Double
    if t == ScalarType.Bool:
        return ScalarType.Bool
    return ScalarType.Long


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x converted to `dtype` as XLA converts: float -> integer saturates
    at the integer type's range and sends NaN to 0; all else is torch's
    `.to` (round to nearest even, integer wrap).  Returns x itself when
    its dtype already is `dtype`."""
    if x.dtype == dtype:
        return x
    if x.is_floating_point() and not dtype.is_floating_point and dtype != torch.bool:
        info = torch.iinfo(dtype)
        wide = torch.nan_to_num(x.double(), nan=0.0)
        # int64's range is not exact in float64: clamp below 2^63
        hi = float(info.max) if info.bits < 64 else 9.223372036854775e18
        x = wide.clamp(float(info.min), hi).trunc()
    return x.to(dtype)
