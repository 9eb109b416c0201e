"""MATLAB numeric class system: classes, promotion, saturation, rounding.

Reference parity: runmat-builtins/src/lib.rs:124-134 (IntValue: 8 integer classes
with saturating arithmetic), :426-436 (Tensor logical dtype on host storage), and
the binary-op class-resolution rules exercised throughout runmat-runtime's
elementwise builtins. Implemented from MATLAB semantics, not translated code.

'double' is the MATLAB default; the accel layer decides placement and
precision — this module is pure host semantics shared by every layer.
"""

from __future__ import annotations

import numpy as np

from .errors import MatError, mixed_int_error

# Canonical MATLAB class names.
FLOAT_CLASSES = ("double", "single")
INT_CLASSES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64")
NUMERIC_CLASSES = FLOAT_CLASSES + INT_CLASSES
ALL_CLASSES = NUMERIC_CLASSES + ("logical", "char", "string", "cell", "struct", "function_handle")

_NP_REAL = {
    "double": np.float64,
    "single": np.float32,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "uint64": np.uint64,
    "logical": np.bool_,
    "char": np.uint32,  # code points
}

_NP_COMPLEX = {"double": np.complex128, "single": np.complex64}

_INT_RANGE = {c: (np.iinfo(_NP_REAL[c]).min, np.iinfo(_NP_REAL[c]).max) for c in INT_CLASSES}


def np_dtype(mclass: str, is_complex: bool = False):
    if is_complex:
        if mclass not in _NP_COMPLEX:
            raise MatError("MATLAB:complexInteger", f"Complex {mclass} values are not supported.")
        return _NP_COMPLEX[mclass]
    return _NP_REAL[mclass]


def is_integer_class(mclass: str) -> bool:
    return mclass in INT_CLASSES


def is_float_class(mclass: str) -> bool:
    return mclass in FLOAT_CLASSES


def is_numeric_class(mclass: str) -> bool:
    return mclass in NUMERIC_CLASSES


def int_range(mclass: str) -> tuple[int, int]:
    return _INT_RANGE[mclass]


def combine_classes(a: str, b: str) -> str:
    """MATLAB binary-op result class for arithmetic.

    Rules (MATLAB):
      int ∘ {same int, double, logical, char} -> int; int ∘ single -> error;
      int ∘ other int -> error; single ∘ {double, single, logical, char} -> single;
      everything else -> double (logical/char arithmetic yields double).
    """
    ai, bi = is_integer_class(a), is_integer_class(b)
    if ai or bi:
        if ai and bi:
            if a != b:
                raise mixed_int_error()
            return a
        other = b if ai else a
        icls = a if ai else b
        if other == "single":
            raise mixed_int_error()
        if other in ("double", "logical", "char") or other == icls:
            return icls
        raise mixed_int_error()
    if a == "single" or b == "single":
        return "single"
    return "double"


def round_half_away(x):
    """MATLAB double->integer conversion rounds half away from zero (np.rint is
    half-to-even, so it cannot be used)."""
    return np.trunc(x + np.copysign(0.5, x))


def saturate_cast(data: np.ndarray, mclass: str) -> np.ndarray:
    """Cast float data to an integer class with MATLAB rounding + saturation.

    NaN maps to 0; +/-Inf map to the class limits.
    """
    lo, hi = _INT_RANGE[mclass]
    d = np.asarray(data)
    if np.iscomplexobj(d):
        d = d.real
    r = round_half_away(d.astype(np.float64, copy=False))
    r = np.where(np.isnan(r), 0.0, r)
    r = np.clip(r, float(lo), float(hi))
    # Values beyond f64's exact int range clip correctly because lo/hi round
    # toward the interior for int64/uint64 limits representable in f64.
    out = r.astype(_NP_REAL[mclass])
    # Repair the top-end of (u)int64 where float rounding can overflow.
    if mclass in ("int64", "uint64"):
        out = np.where(r >= float(hi), np.array(hi, dtype=_NP_REAL[mclass]), out)
        out = np.where(r <= float(lo), np.array(lo, dtype=_NP_REAL[mclass]), out)
    return out


def cast_to_class(data: np.ndarray, mclass: str) -> np.ndarray:
    """Convert host data to the numpy dtype of `mclass` with MATLAB conversion
    semantics (saturation for ints, truncation of imaginary part disallowed)."""
    d = np.asarray(data)
    if mclass in INT_CLASSES:
        if d.dtype.kind in "iub":
            # int -> int: saturate via float64 path only when narrowing.
            lo, hi = _INT_RANGE[mclass]
            return np.clip(d, lo, hi).astype(_NP_REAL[mclass]) if d.dtype != _NP_REAL[mclass] else d
        return saturate_cast(d, mclass)
    if mclass == "logical":
        if np.iscomplexobj(d):
            raise MatError("MATLAB:conversionToLogical", "Conversion to logical from complex is not possible.")
        if d.dtype.kind == "f" and np.isnan(d).any():
            raise MatError("MATLAB:nologicalnan", "NaN's cannot be converted to logicals.")
        return d.astype(np.bool_)
    if mclass in FLOAT_CLASSES:
        if np.iscomplexobj(d):
            return d.astype(_NP_COMPLEX[mclass])
        return d.astype(_NP_REAL[mclass])
    if mclass == "char":
        r = d.real if np.iscomplexobj(d) else d
        r = np.clip(round_half_away(np.asarray(r, dtype=np.float64)), 0, 0x10FFFF)
        return r.astype(np.uint32)
    raise MatError("MATLAB:invalidConversion", f"Cannot convert to class '{mclass}'.")


def class_of_np(d: np.ndarray) -> str:
    k = d.dtype
    if k == np.bool_:
        return "logical"
    for name, t in _NP_REAL.items():
        if name in ("logical", "char"):
            continue
        if k == t:
            return name
    if k == np.complex128:
        return "double"
    if k == np.complex64:
        return "single"
    raise MatError("MATLAB:invalidType", f"Unsupported numpy dtype {k}.")
