"""Central operation dispatcher: class rules, broadcasting, device routing.

Reference parity: runmat-runtime/src/dispatcher.rs (async builtin dispatcher
with GPU gather-retry) + the VM's auto-promotion hooks
(runmat-vm/src/accel/auto_promote.rs, runmat-accelerate/src/native_auto.rs).
Every VM arithmetic instruction and most numeric builtins funnel through
`binary`/`unary` here, which:

  1. resolve the MATLAB result class (dtypes.combine_classes),
  2. route to the accel engine when an operand is device-resident or the
     auto-offload policy elects to promote (≙ native_auto promote_binary),
  3. otherwise execute eagerly on host numpy with MATLAB edge semantics
     (integer saturation, complex domain promotion, NaN rules).
"""

from __future__ import annotations

import numpy as np

from .. import dtypes
from ..errors import MatError, dim_mismatch
from ..ops import table
from ..values import MatArray, StringArray, CellArray, StructArray, is_char

_INT_SAFE_BINARY = {"add", "sub", "mul", "div", "ldiv", "pow", "mod", "rem", "min2", "max2"}


# --------------------------------------------------------------------------- #
# engine plumbing (set by accel.init; None = host-only)
# --------------------------------------------------------------------------- #

def _engine():
    from ..accel import active_engine
    return active_engine()


# --------------------------------------------------------------------------- #
# coercion helpers
# --------------------------------------------------------------------------- #

def as_matarray(v, what: str = "operand") -> MatArray:
    if isinstance(v, MatArray):
        return v
    if isinstance(v, StringArray):
        raise MatError("MATLAB:UndefinedFunction",
                       f"Operator not defined for string {what}s here.")
    raise MatError("MATLAB:UndefinedFunction",
                   f"Operator not defined for '{type(v).__name__}' {what}s.")


def numeric_host(a: MatArray) -> np.ndarray:
    """Host ndarray viewed as arithmetic operand (logical/char -> float64)."""
    h = a.host()
    if a.mclass in ("logical", "char"):
        return h.astype(np.float64)
    return h


def _arith_class(a: MatArray, b: MatArray) -> str:
    return dtypes.combine_classes(a.mclass, b.mclass)


def _wrap(data: np.ndarray, mclass: str) -> MatArray:
    d = np.asarray(data)
    if d.ndim == 0:
        d = d.reshape(1, 1)
    elif d.ndim == 1:
        d = d.reshape(1, -1)
    return MatArray(d, mclass)


def _broadcast_check(sa, sb):
    """MATLAB implicit expansion: each dim must match or be 1. Unlike numpy,
    MATLAB aligns LEADING dimensions (missing trailing dims are 1)."""
    la, lb = len(sa), len(sb)
    n = max(la, lb)
    for i in range(n):
        da = sa[i] if i < la else 1
        db = sb[i] if i < lb else 1
        if da != db and da != 1 and db != 1:
            raise dim_mismatch(
                "Arrays have incompatible sizes for this operation.")


def align_ranks(ha: np.ndarray, hb: np.ndarray):
    """Right-pad the lower-rank operand with singleton dims so numpy broadcasting
    matches MATLAB's leading-dim alignment."""
    if ha.ndim == hb.ndim:
        return ha, hb
    if ha.ndim < hb.ndim:
        ha = ha.reshape(ha.shape + (1,) * (hb.ndim - ha.ndim))
    else:
        hb = hb.reshape(hb.shape + (1,) * (ha.ndim - hb.ndim))
    return ha, hb


def matlab_broadcast_shape(sa, sb) -> tuple:
    la, lb = len(sa), len(sb)
    n = max(la, lb)
    out = []
    for i in range(n):
        da = sa[i] if i < la else 1
        db = sb[i] if i < lb else 1
        out.append(max(da, db))
    return tuple(out)


# --------------------------------------------------------------------------- #
# elementwise binary
# --------------------------------------------------------------------------- #

def _obj_binop(op: str, a, b):
    """Generic object operator protocol: a value type implementing
    `_mat_binop_(op, other, swapped)` overloads the operator (≙ classdef
    operator methods like decomposition.mldivide / tf.plus registered as
    dotted builtins in the reference)."""
    if hasattr(a, "_mat_binop_"):
        r = a._mat_binop_(op, b, False)
        if r is not NotImplemented:
            return r
    if hasattr(b, "_mat_binop_"):
        r = b._mat_binop_(op, a, True)
        if r is not NotImplemented:
            return r
    return None


def binary(op: str, a, b):
    """Elementwise binary op with MATLAB class/broadcast semantics.

    op: name in ops.table.BINARY ('add','sub','mul','div','pow','mod',...).
    """
    r = _obj_binop(op, a, b)
    if r is not None:
        return r
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix) or isinstance(b, SparseMatrix):
        return _sparse_binary(op, a, b)
    if type(a).__name__ in ("MatDatetime", "MatDuration") or \
            type(b).__name__ in ("MatDatetime", "MatDuration"):
        from .builtins.datetime_builtins import dt_binary
        r = dt_binary(op, a, b)
        if r is not None:
            return r
    if type(a).__name__ == "SymValue" or type(b).__name__ == "SymValue":
        from .builtins.symbolic import sym_binary
        r = sym_binary(op, a, b)
        if r is not None:
            return r
    # string concatenation via plus (MATLAB string class semantics)
    if op == "add" and (isinstance(a, StringArray) or isinstance(b, StringArray)):
        return _string_plus(a, b)
    # string relational/equality operators (doc: strings compare
    # lexicographically with < > <= >=; vs numeric the STRING side is
    # converted with double(); missing compares like NaN)
    if op in ("eq", "ne", "lt", "gt", "le", "ge") and \
            (isinstance(a, StringArray) or isinstance(b, StringArray)):
        return _string_compare(op, a, b)
    a = as_matarray(a)
    b = as_matarray(b)

    if op in table.COMPARE_OPS:
        return _compare(op, a, b)
    if op in table.LOGICAL_OPS:
        return _logical(op, a, b)

    out_class = _arith_class(a, b)

    eng = _engine()
    if eng is not None and eng.route_binary(op, a, b):
        return eng.binary(op, a, b, out_class)

    ha, hb = numeric_host(a), numeric_host(b)
    _broadcast_check(a.shape, b.shape)
    ha, hb = align_ranks(ha, hb)

    if dtypes.is_integer_class(out_class) and op in _INT_SAFE_BINARY:
        with np.errstate(all="ignore"):
            r = table.BINARY[op](np, ha.astype(np.float64), hb.astype(np.float64))
        return _wrap(dtypes.saturate_cast(r, out_class), out_class)

    # complex domain promotion for pow with negative base and non-integer exponent
    if op == "pow" and not np.iscomplexobj(ha) and not np.iscomplexobj(hb):
        if (np.any(ha < 0) if ha.size else False):
            hbr = hb
            if not np.all(hbr == np.floor(hbr)):
                ha = ha.astype(np.complex128)

    with np.errstate(all="ignore"):
        try:
            r = table.BINARY[op](np, ha, hb)
        except ValueError:
            raise dim_mismatch("Arrays have incompatible sizes for this operation.")
    if np.iscomplexobj(r) and np.all(r.imag == 0) and op == "pow":
        r = r.real
    return _wrap(dtypes.cast_to_class(r, out_class), out_class)


def _compare(op: str, a: MatArray, b: MatArray):
    eng = _engine()
    if eng is not None and eng.route_binary(op, a, b):
        return eng.binary(op, a, b, "logical")
    ha, hb = a.host(), b.host()
    # char vs text compare by code points; complex ordered compare uses real part
    if a.mclass in ("logical", "char"):
        ha = ha.astype(np.float64)
    if b.mclass in ("logical", "char"):
        hb = hb.astype(np.float64)
    if op not in ("eq", "ne"):
        if np.iscomplexobj(ha):
            ha = ha.real
        if np.iscomplexobj(hb):
            hb = hb.real
    _broadcast_check(a.shape, b.shape)
    ha, hb = align_ranks(ha, hb)
    with np.errstate(invalid="ignore"):
        try:
            r = table.BINARY[op](np, ha, hb)
        except ValueError:
            raise dim_mismatch("Arrays have incompatible sizes for this operation.")
    return _wrap(r.astype(np.bool_), "logical")


def _logical(op: str, a: MatArray, b: MatArray):
    eng = _engine()
    if eng is not None and eng.route_binary(op, a, b):
        return eng.binary(op, a, b, "logical")
    ha, hb = a.host(), b.host()
    if np.iscomplexobj(ha) or np.iscomplexobj(hb):
        raise MatError("MATLAB:invalidLogicalOperand",
                       "Operands to logical operations must be real.")
    if a.mclass == "double" and ha.dtype.kind == "f" and np.isnan(ha).any() or \
       b.mclass == "double" and hb.dtype.kind == "f" and np.isnan(hb).any():
        raise MatError("MATLAB:nologicalnan", "NaN's cannot be converted to logicals.")
    ha, hb = align_ranks(ha, hb)
    _broadcast_check(a.shape, b.shape)
    try:
        r = table.BINARY[op](np, ha, hb)
    except ValueError:
        raise dim_mismatch("Arrays have incompatible sizes for this operation.")
    return _wrap(r.astype(np.bool_), "logical")


def _string_plus(a, b):
    sa = _to_string_array(a)
    sb = _to_string_array(b)
    _broadcast_check(sa.shape, sb.shape)
    ra = np.broadcast_to(sa.data, np.broadcast_shapes(sa.shape, sb.shape))
    rb = np.broadcast_to(sb.data, np.broadcast_shapes(sa.shape, sb.shape))
    out = np.empty(ra.shape, dtype=object)
    fa, fb, fo = ra.reshape(-1), rb.reshape(-1), out.reshape(-1)
    for i in range(fo.size):
        x, y = fa[i], fb[i]
        fo[i] = None if x is None or y is None else x + y
    return StringArray(out)


def _string_compare(op: str, a, b):
    """String relational/equality semantics (≙ runmat-runtime string
    compare builtins): string vs string/char/cellstr compares text
    lexicographically (by code point); string vs NUMERIC converts the
    string side with double() (doc eq: '"5" == 5 is true'); a missing
    string compares like NaN (every comparison false, ~= true)."""
    other = b if isinstance(a, StringArray) else a
    if isinstance(other, MatArray) and other.mclass not in ("char",):
        # numeric/logical side: convert the string side to double
        sv = a if isinstance(a, StringArray) else b
        nums = np.empty(sv.shape, dtype=np.float64)
        fn, fs = nums.reshape(-1), sv.data.reshape(-1)
        for i in range(fn.size):
            s = fs[i]
            if s is None:
                fn[i] = np.nan
            else:
                try:
                    fn[i] = float(s)
                except ValueError:
                    fn[i] = np.nan
        na = MatArray(nums, "double")
        return _compare(op, na if isinstance(a, StringArray) else other,
                        other if isinstance(a, StringArray) else na)
    sa = _to_string_array(a)
    sb = _to_string_array(b)
    _broadcast_check(sa.shape, sb.shape)
    shp = np.broadcast_shapes(sa.shape, sb.shape)
    ra = np.broadcast_to(sa.data, shp)
    rb = np.broadcast_to(sb.data, shp)
    out = np.empty(shp, dtype=np.bool_)
    fa, fb, fo = ra.reshape(-1), rb.reshape(-1), out.reshape(-1)
    import operator as _oper
    pyop = {"eq": _oper.eq, "ne": _oper.ne, "lt": _oper.lt,
            "gt": _oper.gt, "le": _oper.le, "ge": _oper.ge}[op]
    for i in range(fo.size):
        x, y = fa[i], fb[i]
        if x is None or y is None:
            fo[i] = (op == "ne")      # missing: NaN-like semantics
        else:
            fo[i] = bool(pyop(x, y))
    return _wrap(out, "logical")


def _to_string_array(v) -> StringArray:
    if isinstance(v, StringArray):
        return v
    if isinstance(v, MatArray):
        if v.mclass == "char":
            return StringArray.scalar(v.to_str())
        h = v.host()
        out = np.empty(h.shape, dtype=object)
        fo, fh = out.reshape(-1), h.reshape(-1)
        for i in range(fo.size):
            x = fh[i]
            fo[i] = _fmt_num_short(x)
        return StringArray(out)
    raise MatError("MATLAB:string:conversion", "Cannot convert value to string.")


def _fmt_num_short(x) -> str:
    xf = float(x)
    if xf == int(xf) and abs(xf) < 1e15:
        return str(int(xf))
    return repr(xf)


# --------------------------------------------------------------------------- #
# elementwise unary
# --------------------------------------------------------------------------- #

_LOGICAL_OUT_UNARY = {"isnan", "isinf", "isfinite", "logical_not"}
_REAL_OUT_UNARY = {"abs", "real", "imag", "angle"}
_INT_PRESERVING_UNARY = {"neg", "uplus", "abs", "sign", "floor", "ceil", "fix",
                         "round", "square", "real", "imag", "conj", "mod"}


def unary(op: str, a):
    if hasattr(a, "_mat_unop_"):
        r = a._mat_unop_(op)
        if r is not NotImplemented:
            return r
    if type(a).__name__ == "SymValue":
        from .builtins.symbolic import sym_unary
        r = sym_unary(op, a)
        if r is not None:
            return r
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        fn = table.UNARY.get(op)
        if fn is not None and float(fn(np, np.zeros(1))[0]) == 0.0:
            return a.map_nonzeros(lambda d: fn(np, d)).prune()
        return unary(op, a.to_matarray())
    return _unary_impl(op, a)


def _unary_impl(op: str, a) -> MatArray:
    a = as_matarray(a)
    out_class = _unary_out_class(op, a)

    eng = _engine()
    if eng is not None and eng.route_unary(op, a):
        # Device policy: real-domain math (sqrt(-1) -> NaN on device, like GPU
        # libraries); host path below performs MATLAB complex promotion. An
        # explicitly complex device array keeps complex semantics.
        return eng.unary(op, a, out_class)

    h = numeric_host(a)

    if op in _LOGICAL_OUT_UNARY:
        if op == "logical_not":
            if np.iscomplexobj(h):
                raise MatError("MATLAB:invalidLogicalOperand",
                               "Operands to logical operations must be real.")
            return _wrap(h == 0, "logical")
        if np.iscomplexobj(h):
            if op == "isnan":
                return _wrap(np.isnan(h.real) | np.isnan(h.imag), "logical")
            if op == "isinf":
                return _wrap(np.isinf(h.real) | np.isinf(h.imag), "logical")
            return _wrap(np.isfinite(h.real) & np.isfinite(h.imag), "logical")
        return _wrap(table.UNARY[op](np, h), "logical")

    if dtypes.is_integer_class(out_class):
        with np.errstate(all="ignore"):
            r = table.UNARY[op](np, h.astype(np.float64))
        return _wrap(dtypes.saturate_cast(r, out_class), out_class)

    # complex domain promotion
    if op in table.COMPLEX_PROMOTING_UNARY and not np.iscomplexobj(h):
        if h.size and table.COMPLEX_PROMOTING_UNARY[op](h):
            h = h.astype(np.complex128 if out_class == "double" else np.complex64)

    if np.iscomplexobj(h) and op in ("round", "floor", "ceil", "fix"):
        fr = table.UNARY[op](np, h.real)
        fi = table.UNARY[op](np, h.imag)
        return _wrap(dtypes.cast_to_class(fr + 1j * fi, out_class), out_class)

    if np.iscomplexobj(h) and op not in table.COMPLEX_OK_UNARY:
        raise MatError("MATLAB:UndefinedFunction",
                       f"'{op}' is not defined for complex inputs.")

    with np.errstate(all="ignore"):
        r = table.UNARY[op](np, h)
    if op in _REAL_OUT_UNARY and np.iscomplexobj(r):
        r = r.real
    return _wrap(dtypes.cast_to_class(r, out_class), out_class)


def _unary_out_class(op: str, a: MatArray) -> str:
    if op in _LOGICAL_OUT_UNARY:
        return "logical"
    if dtypes.is_integer_class(a.mclass):
        if op not in _INT_PRESERVING_UNARY:
            raise MatError("MATLAB:UndefinedFunction",
                           f"Function '{op}' is not defined for integer class {a.mclass}.")
        return a.mclass
    if a.mclass == "single":
        return "single"
    return "double"


# --------------------------------------------------------------------------- #
# matrix binary ops: mtimes, mldivide, mrdivide, mpower
# --------------------------------------------------------------------------- #

def mtimes(a, b):
    r = _obj_binop("mtimes", a, b)
    if r is not None:
        return r
    if type(a).__name__ == "SymValue" or type(b).__name__ == "SymValue":
        return binary("mul", a, b)
    if type(a).__name__ in ("MatDatetime", "MatDuration") or \
            type(b).__name__ in ("MatDatetime", "MatDuration"):
        return binary("mul", a, b)
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix) or isinstance(b, SparseMatrix):
        if isinstance(a, SparseMatrix) and isinstance(b, SparseMatrix):
            return a.spmm(b)
        if isinstance(a, SparseMatrix):
            if getattr(b, "size", 0) == 1:
                return a.map_nonzeros(lambda d: d * float(b.host().reshape(-1)[0])).prune()
            return MatArray(a.matmul(b.host().astype(np.float64)), "double")
        if getattr(a, "size", 0) == 1:
            return b.map_nonzeros(lambda d: float(a.host().reshape(-1)[0]) * d).prune()
        return MatArray(b.transpose().matmul(a.host().astype(np.float64).T).T.copy(),
                        "double")
    a, b = as_matarray(a), as_matarray(b)
    if a.is_scalar or b.is_scalar:
        return binary("mul", a, b)
    out_class = _arith_class(a, b)
    if dtypes.is_integer_class(out_class):
        raise MatError("MATLAB:mtimes:integerNotSupported",
                       "MTIMES is only supported for integer scalars.")
    eng = _engine()
    if eng is not None and eng.route_matmul(a, b):
        return eng.matmul(a, b, out_class)
    ha, hb = numeric_host(a), numeric_host(b)
    if ha.ndim != 2 or hb.ndim != 2:
        raise MatError("MATLAB:mtimes:inputsMustBe2D",
                       "Arguments must be 2-D, or at least one argument must be scalar.")
    if ha.shape[1] != hb.shape[0]:
        raise MatError(
            "MATLAB:innerdim",
            "Incorrect dimensions for matrix multiplication. Check that the number of "
            "columns in the first matrix matches the number of rows in the second matrix.")
    r = ha @ hb
    return _wrap(dtypes.cast_to_class(r, out_class), out_class)


def mldivide(a, b):
    """A\\b: square -> factorized solve; rectangular -> least squares.

    Reference parity: AccelProvider::mldivide/linsolve
    (runmat-accelerate-api/src/lib.rs:2422-2530); host LAPACK paths
    (runmat-runtime/src/lapack.rs).
    """
    r = _obj_binop("mldivide", a, b)
    if r is not None:
        return r
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        bb = b.to_dense() if isinstance(b, SparseMatrix) else \
            b.host().astype(np.float64)
        return MatArray(a.solve(bb), "double")
    if isinstance(b, SparseMatrix):
        b = b.to_matarray()
    a, b = as_matarray(a), as_matarray(b)
    if a.is_scalar:
        return binary("ldiv", a, b)
    out_class = _arith_class(a, b)
    if dtypes.is_integer_class(out_class):
        raise MatError("MATLAB:mldivide:integerNotSupported",
                       "MLDIVIDE is not supported for integer classes.")
    eng = _engine()
    if eng is not None and eng.route_linalg(a, b):
        sa, sb = a.shape, b.shape
        if len(sa) == 2 and len(sb) == 2 and sa[0] == sb[0] \
                and a.size and b.size:
            # square -> LU solve on device; rectangular -> QR least squares
            # (≙ provider mldivide, runmat-accelerate-api/src/lib.rs:2422)
            kind = "solve" if sa[0] == sa[1] else "lstsq"
            out = eng.linalg(kind, [a, b], out_class=out_class)
            if out is None and kind == "solve":
                # LU solve unsupported for this dtype (observed: f64 LU custom
                # calls fail on some backends while QR works) -> QR solve,
                # still on device
                out = eng.linalg("lstsq", [a, b], out_class=out_class)
            if out is not None:
                return out[0]
    ha, hb = numeric_host(a), numeric_host(b)
    if hb.ndim != 2 or ha.ndim != 2:
        raise MatError("MATLAB:mldivide:inputsMustBe2D", "Arguments must be 2-D.")
    if ha.shape[0] != hb.shape[0]:
        raise dim_mismatch("Matrix dimensions must agree.")
    f64 = np.complex128 if (np.iscomplexobj(ha) or np.iscomplexobj(hb)) else np.float64
    A = ha.astype(f64)
    B = hb.astype(f64)
    if A.shape[0] == A.shape[1]:
        try:
            r = np.linalg.solve(A, B)
        except np.linalg.LinAlgError:
            r = np.linalg.lstsq(A, B, rcond=None)[0]
    else:
        r = np.linalg.lstsq(A, B, rcond=None)[0]
    return _wrap(dtypes.cast_to_class(r, out_class), out_class)


def mrdivide(a, b):
    r = _obj_binop("mrdivide", a, b)
    if r is not None:
        return r
    if type(a).__name__ == "SymValue" or type(b).__name__ == "SymValue":
        return binary("div", a, b)
    return _mrdivide_impl(a, b)


def _mrdivide_impl(a, b) -> MatArray:
    a, b = as_matarray(a), as_matarray(b)
    if b.is_scalar:
        return binary("div", a, b)
    # a/b = (b' \ a')'
    res = mldivide(ctranspose(b), ctranspose(a))
    return ctranspose(res)


def mpower(a, b):
    r = _obj_binop("mpower", a, b)
    if r is not None:
        return r
    if type(a).__name__ == "SymValue" or type(b).__name__ == "SymValue":
        return binary("pow", a, b)
    return _mpower_impl(a, b)


def _mpower_impl(a, b) -> MatArray:
    a, b = as_matarray(a), as_matarray(b)
    if a.is_scalar and b.is_scalar:
        return binary("pow", a, b)
    if b.is_scalar:
        ha = numeric_host(a)
        if ha.ndim != 2 or ha.shape[0] != ha.shape[1]:
            raise MatError("MATLAB:mpower:notSquare", "Matrix must be square.")
        p = b.scalar_double()
        if p == int(p):
            r = np.linalg.matrix_power(ha.astype(np.complex128 if np.iscomplexobj(ha) else np.float64), int(p))
        else:
            w, v = np.linalg.eig(ha.astype(np.complex128))
            r = (v * (w ** p)) @ np.linalg.inv(v)
            if not np.iscomplexobj(ha) and np.allclose(r.imag, 0):
                r = r.real
        out_class = "single" if a.mclass == "single" else "double"
        return _wrap(dtypes.cast_to_class(r, out_class), out_class)
    raise MatError("MATLAB:mpower:inputsMustBeScalarOrSquare",
                   "Inputs must be a scalar and a square matrix.")


# --------------------------------------------------------------------------- #
# transpose
# --------------------------------------------------------------------------- #

def transpose(a):
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        return a.transpose()
    if type(a).__name__ in ("MatDatetime", "MatDuration"):
        if a.data.ndim > 2:
            raise MatError("MATLAB:transpose:NDArray",
                           "Transpose on ND array is not defined. Use PERMUTE instead.")
        return type(a)(a.data.T.copy())
    a = as_matarray(a)
    if len(a.shape) > 2:
        raise MatError("MATLAB:transpose:NDArray",
                       "Transpose on ND array is not defined. Use PERMUTE instead.")
    eng = _engine()
    if a.on_device and eng is not None:
        return eng.transpose(a, conj=False)
    return MatArray(a.host().T.copy(), a.mclass)


def ctranspose(a):
    from ..sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        return a.transpose()   # sparse is real double: ' == .'
    if type(a).__name__ in ("MatDatetime", "MatDuration"):
        return transpose(a)    # timelike values are real: ' == .'
    a = as_matarray(a)
    if len(a.shape) > 2:
        raise MatError("MATLAB:transpose:NDArray",
                       "Transpose on ND array is not defined. Use PERMUTE instead.")
    eng = _engine()
    if a.on_device and eng is not None:
        return eng.transpose(a, conj=True)
    h = a.host()
    r = h.conj().T if np.iscomplexobj(h) else h.T
    return MatArray(r.copy(), a.mclass)


def _sparse_binary(op, a, b):
    """Sparse elementwise semantics: ops where zeros stay zero keep sparsity;
    everything else densifies (MATLAB rules for +,-,.*,&)."""
    from ..sparse import SparseMatrix
    sa = isinstance(a, SparseMatrix)
    sb = isinstance(b, SparseMatrix)
    if sa and sb:
        if op in ("add", "sub"):
            fn = (lambda x, y: x + y) if op == "add" else (lambda x, y: x - y)
            return a._binary_sparse(b, fn)
        if op in ("mul", "and"):
            return a._binary_sparse(b, lambda x, y: x * y)
        return binary(op, a.to_matarray(), b.to_matarray())
    sp, dn = (a, b) if sa else (b, a)
    dsize = getattr(dn, "size", None)
    if op == "mul" and dsize == 1:
        c = float(dn.host().reshape(-1)[0])
        return sp.map_nonzeros(lambda d: d * c).prune()
    if op == "mul" and getattr(dn, "shape", None) == sp.shape:
        hd = dn.host().astype(np.float64)
        ii, jj, vv = sp.triplets()
        return SparseMatrix.from_triplets(ii, jj, vv * hd[ii, jj],
                                          sp.m, sp.n).prune()
    da = sp.to_matarray() if sa else a
    db = sp.to_matarray() if sb else b
    return binary(op, da if sa else a, b if sa else db)
