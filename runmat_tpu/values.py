"""The MATLAB value model: arrays, cells, structs, strings, function handles.

Reference parity: runmat-builtins/src/lib.rs:73-123 (Value enum, 23 variants) and
:426-436 (Tensor: column-major shape + logical dtype). Design differences here:

  * Host storage is numpy with the *MATLAB logical shape*; all order-sensitive
    semantics (linear indexing, reshape, (:) ) go through explicit Fortran-order
    helpers rather than a fixed column-major buffer, which lets device residency
    map 1:1 onto `jax.Array`s whose layout XLA controls.
  * Device residency (reference: GpuTensorHandle + residency tables,
    runmat-accelerate-api/src/lib.rs:260-264) is `MatArray._dev`: a duck-typed
    handle owned by the accel engine (a lazy op-DAG node or a live jax.Array).
    An array is either host- or device-resident; `gather()` materializes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from . import dtypes
from .errors import MatError


# --------------------------------------------------------------------------- #
# shape helpers
# --------------------------------------------------------------------------- #

def normalize_shape(shape) -> tuple[int, ...]:
    """MATLAB arrays have >= 2 dims; trailing singleton dims beyond 2 are trimmed."""
    s = tuple(int(d) for d in shape)
    if len(s) == 0:
        s = (1, 1)
    elif len(s) == 1:
        s = (s[0], 1) if s[0] != 1 else (1, 1)
    while len(s) > 2 and s[-1] == 1:
        s = s[:-1]
    return s


def fortran_ravel(a: np.ndarray) -> np.ndarray:
    return np.ravel(a, order="F")


def fortran_reshape(a: np.ndarray, shape) -> np.ndarray:
    return np.reshape(a, shape, order="F")


# --------------------------------------------------------------------------- #
# MatArray
# --------------------------------------------------------------------------- #

class MatArray:
    """A MATLAB numeric / logical / char array.

    `mclass` is the MATLAB class name; complexness is carried by the numpy dtype.
    Exactly one of `_host` (numpy ndarray, shape == MATLAB shape) or `_dev`
    (accel handle) is set.
    """

    __slots__ = ("_host", "_dev", "mclass", "shared", "dl")

    def __init__(self, host: Optional[np.ndarray], mclass: str, dev: Any = None):
        self._host = host
        self._dev = dev
        self.mclass = mclass
        # dlarray marker (deep-learning toolbox; see runmat_tpu/dl/autodiff.py)
        self.dl = False
        # Copy-on-write flag (≙ reference GC value semantics + residency
        # copy-on-write, SpawnHandleConcurrency::CopyOnWrite in
        # runmat-accelerate-api/src/lib.rs:824-845): set when this array is
        # reachable from more than one binding; indexed writes must copy first.
        self.shared = False

    # -- constructors ------------------------------------------------------- #

    @staticmethod
    def from_np(data, mclass: Optional[str] = None) -> "MatArray":
        d = np.asarray(data)
        if d.ndim < 2:
            d = d.reshape(normalize_shape(d.shape))
        if mclass is None:
            mclass = dtypes.class_of_np(d)
        return MatArray(d, mclass)

    @staticmethod
    def scalar(x, mclass: str = "double") -> "MatArray":
        dt = dtypes.np_dtype(mclass, is_complex=isinstance(x, complex) and x.imag != 0)
        if isinstance(x, complex) and x.imag == 0:
            x = x.real
        return MatArray(np.full((1, 1), x, dtype=dt), mclass)

    @staticmethod
    def logical_scalar(b: bool) -> "MatArray":
        return MatArray(np.full((1, 1), bool(b), dtype=np.bool_), "logical")

    @staticmethod
    def empty(mclass: str = "double") -> "MatArray":
        return MatArray(np.zeros((0, 0), dtype=dtypes.np_dtype(mclass)), mclass)

    @staticmethod
    def from_device(dev, mclass: str) -> "MatArray":
        return MatArray(None, mclass, dev=dev)

    @staticmethod
    def char_from_str(s: str) -> "MatArray":
        cp = np.array([ord(c) for c in s], dtype=np.uint32).reshape(1, -1) if s else \
            np.zeros((0, 0) if s == "" else (1, 0), dtype=np.uint32)
        if s == "":
            cp = np.zeros((0, 0), dtype=np.uint32)
        return MatArray(cp, "char")

    # -- residency ---------------------------------------------------------- #

    @property
    def on_device(self) -> bool:
        return self._dev is not None

    @property
    def dev(self):
        return self._dev

    def host(self) -> np.ndarray:
        """Materialize to host numpy (gather if device-resident).

        Reference parity: gather / gather_if_needed_async
        (runmat-runtime/src/dispatcher.rs:67-200).
        """
        if self._host is None:
            self._host = np.asarray(self._dev.gather())
            if self._host.ndim < 2:
                self._host = self._host.reshape(normalize_shape(self._host.shape))
            self._dev = None
        return self._host

    # -- properties ---------------------------------------------------------- #

    @property
    def shape(self) -> tuple[int, ...]:
        if self._host is not None:
            return self._host.shape
        return tuple(self._dev.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def is_complex(self) -> bool:
        if self._host is not None:
            return self._host.dtype.kind == "c"
        return bool(getattr(self._dev, "is_complex", False))

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    @property
    def is_scalar(self) -> bool:
        return self.size == 1

    def item(self):
        """Scalar python value (gathers)."""
        h = self.host()
        if h.size != 1:
            raise MatError("MATLAB:notScalar", "Operands must be scalar.")
        v = h.reshape(-1)[0]
        if h.dtype.kind == "c":
            return complex(v)
        if h.dtype.kind == "b":
            return bool(v)
        if h.dtype.kind in "iu":
            return int(v)
        return float(v)

    def scalar_double(self) -> float:
        v = self.item()
        if isinstance(v, complex):
            return v.real
        return float(v)

    def is_true(self) -> bool:
        """MATLAB truthiness: nonempty and all elements nonzero."""
        h = self.host()
        if h.size == 0:
            return False
        return bool(np.all(h != 0))

    def to_str(self) -> str:
        """Char array -> python str (row-major over columns then rows, i.e. a
        1xN char row vector reads naturally; multi-row chars join rows)."""
        if self.mclass == "char":
            h = self.host()
            if h.size == 0:
                return ""
            if h.shape[0] == 1 or h.ndim == 1:
                return "".join(chr(int(c)) for c in h.reshape(-1, order="F" if h.shape[0] != 1 else "C"))
            return "\n".join("".join(chr(int(c)) for c in row) for row in h)
        raise MatError("MATLAB:invalidType", "Expected a character array.")

    def copy(self) -> "MatArray":
        if self._host is not None:
            return MatArray(self._host.copy(), self.mclass)
        return MatArray(None, self.mclass, dev=self._dev)  # device values are immutable

    def __repr__(self) -> str:  # pragma: no cover
        loc = "dev" if self.on_device else "host"
        return f"MatArray<{self.mclass} {'x'.join(map(str, self.shape))} {loc}>"


# --------------------------------------------------------------------------- #
# Strings (MATLAB string class: array of string scalars, may hold <missing>)
# --------------------------------------------------------------------------- #

class StringArray:
    __slots__ = ("data",)
    mclass = "string"

    def __init__(self, data: np.ndarray):
        # object ndarray of python str or None (<missing>), MATLAB shape
        d = np.asarray(data, dtype=object)
        if d.ndim < 2:
            d = d.reshape(normalize_shape(d.shape))
        self.data = d

    @staticmethod
    def scalar(s: Optional[str]) -> "StringArray":
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = s
        return StringArray(a)

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return self.data.size

    @property
    def is_scalar(self):
        return self.data.size == 1

    def item(self) -> Optional[str]:
        return self.data.reshape(-1)[0]

    def __repr__(self):  # pragma: no cover
        return f"StringArray<{'x'.join(map(str, self.shape))}>"


# --------------------------------------------------------------------------- #
# Cells and structs
# --------------------------------------------------------------------------- #

class CellArray:
    __slots__ = ("data",)
    mclass = "cell"

    def __init__(self, data: np.ndarray):
        d = np.asarray(data, dtype=object)
        if d.ndim < 2:
            d = d.reshape(normalize_shape(d.shape))
        self.data = d

    @staticmethod
    def empty(shape=(0, 0)) -> "CellArray":
        return CellArray(np.empty(normalize_shape(shape), dtype=object))

    @staticmethod
    def filled(shape) -> "CellArray":
        d = np.empty(normalize_shape(shape), dtype=object)
        flat = d.reshape(-1)
        for i in range(flat.size):
            flat[i] = MatArray.empty()
        return CellArray(d)

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return self.data.size

    def copy(self) -> "CellArray":
        return CellArray(self.data.copy())

    def __repr__(self):  # pragma: no cover
        return f"CellArray<{'x'.join(map(str, self.shape))}>"


class StructArray:
    """MATLAB struct array: ordered field dict -> object ndarray per field."""

    __slots__ = ("fields", "_shape")
    mclass = "struct"

    def __init__(self, fields: dict[str, np.ndarray], shape):
        self.fields = fields  # each value: object ndarray with shape == _shape
        self._shape = normalize_shape(shape)

    @staticmethod
    def scalar(pairs: Optional[dict[str, Any]] = None) -> "StructArray":
        fields: dict[str, np.ndarray] = {}
        if pairs:
            for k, v in pairs.items():
                a = np.empty((1, 1), dtype=object)
                a[0, 0] = v
                fields[k] = a
        return StructArray(fields, (1, 1))

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        n = 1
        for d in self._shape:
            n *= d
        return n

    @property
    def is_scalar(self):
        return self.size == 1

    def get_scalar_field(self, name: str):
        if name not in self.fields:
            raise MatError("MATLAB:nonExistentField", f"Unrecognized field name \"{name}\".")
        return self.fields[name].reshape(-1)[0]

    def set_scalar_field(self, name: str, value):
        if name not in self.fields:
            a = np.empty(self._shape, dtype=object)
            flat = a.reshape(-1)
            for i in range(flat.size):
                flat[i] = MatArray.empty()
            self.fields[name] = a
        self.fields[name].reshape(-1)[0] = value

    def copy(self) -> "StructArray":
        return StructArray({k: v.copy() for k, v in self.fields.items()}, self._shape)

    def __repr__(self):  # pragma: no cover
        return f"StructArray<{'x'.join(map(str, self._shape))} fields={list(self.fields)}>"


# --------------------------------------------------------------------------- #
# Function handles
# --------------------------------------------------------------------------- #

class FunctionHandle:
    """@name handles and @(args) expr anonymous functions (with captures).

    Reference parity: Value::FunctionHandle / Closure
    (runmat-builtins/src/lib.rs:73-123).
    """

    __slots__ = ("name", "params", "body", "captures", "kind", "src")
    mclass = "function_handle"

    def __init__(self, kind: str, name: Optional[str] = None, params=None, body=None, captures=None, src: str = ""):
        self.kind = kind  # 'named' | 'anon'
        self.name = name
        self.params = params or []
        self.body = body  # compiled Code for anon
        self.captures = captures or {}
        self.src = src    # unparsed source text (func2str)

    def __repr__(self):  # pragma: no cover
        if self.kind == "named":
            return f"@{self.name}"
        return f"@({', '.join(self.params)}) <anon>"


class OutputList:
    """A comma-list: result of c{:} / struct-array field access / multi-output
    calls. Flattened into argument lists and concatenations by the VM.

    Reference parity: Value::OutputList (runmat-builtins/src/lib.rs:73-123).
    """

    __slots__ = ("items",)

    def __init__(self, items: list):
        self.items = items

    def __repr__(self):  # pragma: no cover
        return f"OutputList({len(self.items)})"


# --------------------------------------------------------------------------- #
# Value helpers used across VM / runtime
# --------------------------------------------------------------------------- #

Value = Any  # MatArray | StringArray | CellArray | StructArray | FunctionHandle


def is_char(v) -> bool:
    return isinstance(v, MatArray) and v.mclass == "char"


def is_text(v) -> bool:
    return is_char(v) or isinstance(v, StringArray)


def text_of(v) -> str:
    """Extract a python str from a char row vector or string scalar."""
    if is_char(v):
        return v.to_str()
    if isinstance(v, StringArray) and v.is_scalar:
        s = v.item()
        if s is None:
            raise MatError("MATLAB:string:MissingNotSupported", "<missing> string not allowed here.")
        return s
    raise MatError("MATLAB:invalidType", "Expected text (char vector or string scalar).")


def class_name(v) -> str:
    if isinstance(v, MatArray):
        return v.mclass
    if type(v).__name__ == "SparseMatrix":
        return v.mclass          # MATLAB: class(sparse(...)) == 'double'
    if type(v).__name__ in ("MatTable", "MatDatetime", "MatDuration",
                            "SymValue"):
        return {"MatTable": "table", "MatDatetime": "datetime",
                "MatDuration": "duration", "SymValue": "sym"}[type(v).__name__]
    cls = getattr(v, "cls", None)
    if cls is not None and hasattr(cls, "name"):  # MatObject / HandleObject
        return cls.name
    return getattr(v, "mclass", type(v).__name__)


def shape_of(v) -> tuple[int, ...]:
    if isinstance(v, (MatArray, StringArray, CellArray, StructArray)):
        return tuple(v.shape)
    if type(v).__name__ in ("SparseMatrix", "MatTable", "MatDatetime",
                            "MatDuration", "SymValue"):
        return tuple(v.shape)
    return (1, 1)


def numel(v) -> int:
    if isinstance(v, (MatArray, StringArray, CellArray, StructArray)):
        return v.size
    if type(v).__name__ in ("SparseMatrix", "MatTable", "MatDatetime",
                            "MatDuration", "SymValue"):
        return v.size
    return 1
