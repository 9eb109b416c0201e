"""Control/utility builtins: feval, deal, nargin/nargout, isequal, eval family,
getenv, tic/toc, command-style environment helpers.

Reference parity: runmat-runtime/src/builtins/control + the HIR eval gates
(runmat-hir/src/lib.rs:36-41: eval/feval/evalin/assignin).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, is_text, numel, text_of)
from ..registry import builtin, register_alias


@builtin("feval", category="control", min_in=1, pass_ctx=True, pass_nargout=True)
def m_feval(f, *args, ctx=None, nargout=1):
    if isinstance(f, FunctionHandle) or hasattr(f, "_mat_paren_call_"):
        return ctx.interp.call_value(f, list(args), nargout, ctx.frame)
    # feval'd callees see no caller identifier names (MATLAB inputname()
    # is empty through feval) — clear any RESOLVE_CALL-set names.
    ctx.interp._current_call_names = None
    return ctx.interp.call_named(text_of(f), list(args), nargout, ctx.frame)


@builtin("deal", category="control", min_in=1, pass_nargout=True)
def m_deal(*args, nargout=1):
    n = max(1, nargout)
    if len(args) == 1:
        return [args[0]] * n
    if len(args) < n:
        raise MatError("MATLAB:deal:narginNargoutMismatch",
                       "The number of outputs should match the number of inputs.")
    return list(args[:n])


@builtin("nargin", category="control", min_in=0, max_in=1, pass_ctx=True)
def m_nargin(f=None, ctx=None):
    if f is None:
        return MatArray.scalar(float(ctx.frame.nargin))
    if isinstance(f, FunctionHandle) and f.kind != "named":
        return MatArray.scalar(float(len(f.params or [])))
    name = f.name if isinstance(f, FunctionHandle) else text_of(f)
    r = ctx.interp.resolve_function(name)
    if r is None:
        raise MatError("MATLAB:narginout:notValidMfile", f"Invalid function name '{name}'.")
    kind, fn = r
    if kind == "user":
        n = len(fn.params)
        return MatArray.scalar(float(-n if fn.has_varargin else n))
    return MatArray.scalar(float(-1 if fn.max_in is None else fn.max_in))


@builtin("nargout", category="control", min_in=0, max_in=1, pass_ctx=True)
def m_nargout(f=None, ctx=None):
    if f is None:
        return MatArray.scalar(float(ctx.frame.nargout))
    name = f.name if isinstance(f, FunctionHandle) else text_of(f)
    r = ctx.interp.resolve_function(name)
    if r is None:
        raise MatError("MATLAB:narginout:notValidMfile", f"Invalid function name '{name}'.")
    kind, fn = r
    if kind == "user":
        n = len(fn.outs)
        return MatArray.scalar(float(-n if fn.has_varargout else n))
    return MatArray.scalar(float(fn.max_out))


def _isequal_impl(a, b, nan_equal: bool) -> bool:
    if isinstance(a, MatArray) and isinstance(b, MatArray):
        if a.mclass == "char" or b.mclass == "char":
            if a.mclass != "char" or b.mclass != "char":
                # char compares by code points against numerics
                pass
        ha, hb = a.host(), b.host()
        if ha.shape != hb.shape:
            return False
        if ha.size == 0:
            return True
        fa = ha.astype(np.complex128) if ha.dtype.kind in "c" else ha.astype(np.float64)
        fb = hb.astype(np.complex128) if hb.dtype.kind in "c" else hb.astype(np.float64)
        eq = fa == fb
        if nan_equal:
            eq = eq | (np.isnan(fa.real) & np.isnan(fb.real))
        return bool(np.all(eq))
    if isinstance(a, StringArray) and isinstance(b, StringArray):
        return a.shape == b.shape and all(
            x == y for x, y in zip(a.data.reshape(-1), b.data.reshape(-1)))
    if isinstance(a, StringArray) or isinstance(b, StringArray):
        try:
            return text_of(a) == text_of(b)
        except MatError:
            return False
    if isinstance(a, CellArray) and isinstance(b, CellArray):
        if a.shape != b.shape:
            return False
        return all(_isequal_impl(x, y, nan_equal)
                   for x, y in zip(a.data.reshape(-1), b.data.reshape(-1)))
    if isinstance(a, StructArray) and isinstance(b, StructArray):
        if a.shape != b.shape or set(a.fields) != set(b.fields):
            return False
        for f in a.fields:
            if not all(_isequal_impl(x, y, nan_equal)
                       for x, y in zip(a.fields[f].reshape(-1), b.fields[f].reshape(-1))):
                return False
        return True
    if isinstance(a, FunctionHandle) and isinstance(b, FunctionHandle):
        return a is b or (a.kind == "named" and b.kind == "named" and a.name == b.name)
    return False


@builtin("isequal", category="control", min_in=2)
def m_isequal(*args):
    return MatArray.logical_scalar(all(_isequal_impl(args[0], x, False) for x in args[1:]))


@builtin("isequaln", category="control", min_in=2)
def m_isequaln(*args):
    return MatArray.logical_scalar(all(_isequal_impl(args[0], x, True) for x in args[1:]))


@builtin("eval", category="control", min_in=1, max_in=2, pass_ctx=True)
def m_eval(src, catch_src=None, ctx=None):
    try:
        ctx.interp.eval_source(text_of(src), ctx.frame)
    except MatError:
        if catch_src is not None:
            ctx.interp.eval_source(text_of(catch_src), ctx.frame)
        else:
            raise
    return None


@builtin("evalin", category="control", min_in=2, max_in=2, pass_ctx=True)
def m_evalin(ws, src, ctx=None):
    w = text_of(ws)
    frame = ctx.session.base_frame if w == "base" else ctx.frame
    ctx.interp.eval_source(text_of(src), frame)
    return None


@builtin("assignin", category="control", min_in=3, max_in=3, pass_ctx=True)
def m_assignin(ws, name, val, ctx=None):
    w = text_of(ws)
    frame = ctx.session.base_frame if w == "base" else ctx.frame
    frame.vars[text_of(name)] = val
    return None


@builtin("getenv", category="control", min_in=1, max_in=1)
def m_getenv(name):
    v = os.environ.get(text_of(name), "")
    return MatArray.char_from_str(v)


@builtin("setenv", category="control", min_in=1, max_in=2)
def m_setenv(name, val=None):
    os.environ[text_of(name)] = text_of(val) if val is not None else ""
    return None


@builtin("tic", category="timing", min_in=0, max_in=0, pass_ctx=True, pass_nargout=True)
def m_tic(ctx=None, nargout=0):
    t = time.perf_counter()
    if nargout >= 1:
        return MatArray.scalar(t * 1e6)
    ctx.session._tic_default = t
    return None


@builtin("toc", category="timing", min_in=0, max_in=1, pass_ctx=True, pass_nargout=True)
def m_toc(timer=None, ctx=None, nargout=0):
    now = time.perf_counter()
    if timer is not None:
        t0 = timer.scalar_double() / 1e6
    else:
        t0 = ctx.session._tic_default
        if t0 is None:
            raise MatError("MATLAB:toc:callTicFirst", "You must call TIC before calling TOC.")
    el = now - t0
    if nargout >= 1:
        return MatArray.scalar(el)
    ctx.session.write(f"Elapsed time is {el:.6f} seconds.\n")
    return None


@builtin("pause", category="timing", min_in=0, max_in=1)
def m_pause(t=None):
    if t is not None and isinstance(t, MatArray):
        time.sleep(min(t.scalar_double(), 10.0))
    return None


@builtin("clear", category="control", min_in=0, pass_ctx=True)
def m_clear(*args, ctx=None):
    names = []
    for a in args:
        names.append(text_of(a))
    if not names or "all" in names or "variables" in names:
        ctx.frame.vars.clear()
        ctx.frame.globals.clear()
    else:
        for n in names:
            ctx.frame.vars.pop(n, None)
    return None


@builtin("clc", category="control", min_in=0, max_in=0)
def m_clc():
    return None


@builtin("rehash", category="control", min_in=0)
def m_rehash(*args):
    return None


@builtin("more", category="control", min_in=0, max_in=1)
def m_more(*args):
    return None


@builtin("version", category="introspection", min_in=0, max_in=1)
def m_version(*args):
    return MatArray.char_from_str("25.1.0 (runmat-tpu)")


@builtin("ver", category="introspection", min_in=0, pass_ctx=True)
def m_ver(*args, ctx=None):
    ctx.session.write("runmat-tpu: MATLAB-compatible runtime on JAX\n")
    return None


@builtin("computer", category="introspection", min_in=0, max_in=0)
def m_computer():
    return MatArray.char_from_str("GLNXA64")


@builtin("isunix", category="introspection", min_in=0, max_in=0)
def m_isunix():
    return MatArray.logical_scalar(True)


@builtin("ispc", category="introspection", min_in=0, max_in=0)
def m_ispc():
    return MatArray.logical_scalar(False)


@builtin("ismac", category="introspection", min_in=0, max_in=0)
def m_ismac():
    return MatArray.logical_scalar(False)


@builtin("usejava", category="introspection", min_in=1, max_in=1)
def m_usejava(kind):
    return MatArray.logical_scalar(False)


@builtin("hold", category="plotting", min_in=0, max_in=1)
def m_hold(*args):
    return None


@builtin("addpath", category="control", min_in=1, pass_ctx=True)
def m_addpath(*args, ctx=None):
    for a in args:
        p = text_of(a)
        ctx.session.search_path.append(p) if hasattr(ctx.session, "search_path") else None
    return None
