"""gpuArray programming model: gpuArray/gather/gpuDevice/arrayfun/...

Reference parity: runmat-runtime/src/builtins/acceleration/gpu/
(gpuarray.rs, gather.rs, gpudevice.rs, arrayfun.rs). "gpuArray" means
device residency in the accel engine (a live/lazy jax array); gather
materializes to host numpy. The same builtins work against the jax-CPU engine
in tests (≙ the reference's in-process fake provider, SURVEY.md §4 item 4).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import CellArray, FunctionHandle, MatArray, StructArray, text_of
from ..registry import builtin


def _engine(required: bool = True):
    from ...accel import active_engine
    eng = active_engine()
    if eng is None and required:
        raise MatError("parallel:gpu:device:NoDevice",
                       "No accelerator device available (engine not initialized).")
    return eng


@builtin("gpuArray", category="acceleration", min_in=1, max_in=1)
def m_gpuarray(x):
    eng = _engine()
    if not isinstance(x, MatArray):
        raise bad_arg("gpuArray", "Input must be numeric or logical.")
    if x.on_device:
        return x
    return eng.upload(x)


@builtin("gather", category="acceleration", min_in=1, max_in=1)
def m_gather(x):
    if isinstance(x, MatArray) and x.on_device:
        x.host()
        return x
    if isinstance(x, CellArray):
        out = x.copy()
        flat = out.data.reshape(-1)
        for i in range(flat.size):
            v = flat[i]
            if isinstance(v, MatArray) and v.on_device:
                v.host()
        return out
    return x


@builtin("distributed", category="acceleration", min_in=1, max_in=1)
def m_distributed(x):
    """distributed(X): device residency sharded over the engine mesh (the
    multi-chip extension, SURVEY.md §2.3 — reference is single-device; on a
    1-chip engine this is equivalent to gpuArray). The largest mesh-divisible
    axis is partitioned over the 'data' axis; XLA GSPMD propagates the
    sharding through all subsequent lazy ops and inserts the collectives."""
    eng = _engine()
    if not isinstance(x, MatArray):
        raise bad_arg("distributed", "Input must be numeric or logical.")
    if x.on_device:
        x.host()
    return eng.upload(x, force_shard=True)


@builtin("isdistributed", category="acceleration", min_in=1, max_in=1)
def m_isdistributed(x):
    if not (isinstance(x, MatArray) and x.on_device):
        return MatArray.logical_scalar(False)
    eng = _engine(required=False)
    if eng is None or eng.mesh is None:
        return MatArray.logical_scalar(False)
    try:
        arr = eng.materialize(x.dev)
        sh = getattr(arr, "sharding", None)
        from jax.sharding import PartitionSpec as P
        return MatArray.logical_scalar(
            sh is not None and getattr(sh, "spec", P()) != P())
    except Exception:
        return MatArray.logical_scalar(False)


@builtin("existsOnGPU", category="acceleration", min_in=1, max_in=1)
def m_exists_on_gpu(x):
    return MatArray.logical_scalar(isinstance(x, MatArray) and x.on_device)


@builtin("isgpuarray", category="acceleration", min_in=1, max_in=1)
def m_isgpuarray(x):
    return MatArray.logical_scalar(isinstance(x, MatArray) and x.on_device)


@builtin("gpuDevice", category="acceleration", min_in=0, max_in=1)
def m_gpudevice(idx=None):
    eng = _engine()
    info = eng.device_info()
    mem = eng.memory_info()
    total = float(mem["bytes_limit"] or info.get("memory", 0))
    in_use = float(mem["bytes_in_use"]) if mem["available"] else \
        float(eng.residency.live_bytes)   # ledger fallback (jax-CPU)
    return StructArray.scalar({
        "Name": MatArray.char_from_str(info["name"]),
        "Index": MatArray.scalar(1.0),
        "TotalMemory": MatArray.scalar(total),
        "AvailableMemory": MatArray.scalar(max(total - in_use, 0.0)),
        "MemoryInUse": MatArray.scalar(in_use),
        "DeviceAvailable": MatArray.logical_scalar(True),
        "Platform": MatArray.char_from_str(info["platform"]),
        "DeviceCount": MatArray.scalar(float(info.get("count", 1))),
    })


@builtin("gpuDeviceCount", category="acceleration", min_in=0, max_in=1)
def m_gpudevicecount(kind=None):
    eng = _engine(required=False)
    if eng is None:
        return MatArray.scalar(0.0)
    return MatArray.scalar(float(eng.device_info().get("count", 1)))


_EW_CALLS = frozenset("""sin cos tan asin acos atan sinh cosh tanh asinh
acosh atanh exp log log2 log10 log1p expm1 sqrt abs sign floor ceil round
fix real imag conj angle atan2 hypot power mod rem times plus minus
rdivide ldivide uminus single double logical erf erfc gamma isnan isinf
isfinite""".split())


def _try_fused_arrayfun(f, arrs, ctx):
    """Whole-array device execution of arrayfun (beats the reference, which
    host-executes scalar fns then re-uploads, gpu/arrayfun.rs:1-7).

    arrayfun guarantees f sees SCALARS, so matrix ops inside f (* / ^ ')
    coincide with their elementwise forms — the anon body's bytecode is
    rewritten accordingly (MTIMES->times, MPOW->power, scalar transpose
    drops, ' -> conj) and run ONCE over the full arrays; every op lands in
    the lazy DAG as one fused kernel. Any opcode outside the elementwise
    subset (indexing, branches, matrix builds) bails to the per-element
    path — speculation is never required for correctness."""
    from ...values import FunctionHandle
    from ...vm import bytecode as B2
    eng = _engine(required=False)
    if eng is None or not arrs:
        return None
    if not all(isinstance(a, MatArray) for a in arrs):
        return None
    if not (any(a.on_device for a in arrs)
            or (eng.auto_offload
                and max(a.size for a in arrs) >= eng.offload_threshold)):
        return None
    if not isinstance(f, FunctionHandle):
        return None
    if f.kind == "named":
        if f.name not in _EW_CALLS:
            return None
        r = ctx.interp.call_named(f.name, list(arrs), 1, ctx.frame)
        return r[0] if r else None
    code = f.body
    if code is None or len(f.params) != len(arrs):
        return None
    for v in f.captures.values():
        if not (isinstance(v, MatArray) and v.size == 1):
            return None
    locals_ = set(f.params) | set(f.captures)
    new = B2.Code(name=code.name, params=list(code.params),
                  outs=list(code.outs))
    new.consts = code.consts
    new.is_script = False
    for idx, (op, a, b, c, d) in enumerate(code.instrs):
        line = code.lines[idx] if idx < len(code.lines) else 0
        if op in (B2.CONST, B2.LOAD, B2.UNOP, B2.DUP, B2.POP, B2.RET,
                  B2.CHECK_INTERRUPT):
            new.emit(op, a, b, c, d, line=line)
        elif op == B2.BINOP:
            new.emit(op, a, b, c, d, line=line)
        elif op == B2.MTIMES:
            new.emit(B2.BINOP, "mul", line=line)
        elif op == B2.MRDIV:
            new.emit(B2.BINOP, "div", line=line)
        elif op == B2.MLDIV:
            new.emit(B2.BINOP, "ldiv", line=line)
        elif op == B2.MPOW:
            new.emit(B2.BINOP, "pow", line=line)
        elif op == B2.TRANSPOSE:
            if a:   # ': complex conjugate on scalars
                new.emit(B2.RESOLVE_CALL, "conj", 1, 1, line=line)
            # plain transpose of a scalar is the identity: drop
        elif op == B2.RESOLVE_CALL:
            nargs, nout = b, c
            if a in locals_ or (nout or 1) > 1:
                return None         # variable indexing / multi-output
            if a in _EW_CALLS and nargs >= 1:
                new.emit(op, a, b, c, d, line=line)
            elif a in ("min", "max") and nargs == 2:
                new.emit(op, a, b, c, d, line=line)
            else:
                return None
        else:
            return None             # branches, indexing, matrix builds, ...
    f2 = FunctionHandle("anon", params=list(f.params), body=new,
                        captures=dict(f.captures), src=f.src)
    try:
        r = ctx.interp.call_value(f2, list(arrs), 1, ctx.frame)
    except MatError:
        return None
    if not r or not isinstance(r[0], MatArray):
        return None
    if tuple(r[0].shape) != tuple(arrs[0].shape):
        return None                 # not elementwise after all: fall back
    return r[0]


@builtin("arrayfun", category="acceleration", min_in=2, pass_ctx=True, pass_nargout=True)
def m_arrayfun(f, *arrays, ctx=None, nargout=1):
    """arrayfun(f, A, ...) elementwise application.

    Device inputs with an elementwise-safe f run as ONE fused device
    kernel (see _try_fused_arrayfun); everything else takes the reference
    semantics path (scalar-at-a-time host execution with 'UniformOutput',
    gpu/arrayfun.rs:1-7)."""
    opts = list(arrays)
    uniform = True
    arrs = []
    i = 0
    while i < len(opts):
        a = opts[i]
        from ...values import is_text
        if is_text(a) and text_of(a) == "UniformOutput":
            uniform = bool(opts[i + 1].is_true()) if i + 1 < len(opts) else True
            i += 2
            continue
        arrs.append(a)
        i += 1
    if not arrs:
        raise bad_arg("arrayfun", "Need at least one array input.")
    for a in arrs[1:]:
        if getattr(a, "shape", None) != getattr(arrs[0], "shape", None):
            raise MatError("MATLAB:arrayfun:ShapeMismatch",
                           "All input arrays must have the same size.")
    if uniform and nargout <= 1:
        fused = _try_fused_arrayfun(f, arrs, ctx)
        if fused is not None:
            return fused
    hs = [a.host() for a in arrs]
    shape = hs[0].shape
    n = hs[0].size
    out_flat: list = []
    flats = [h.reshape(-1, order="F") for h in hs]
    for k in range(n):
        elem_args = [MatArray.from_np(np.array([[fl[k]]]), arrs[j].mclass)
                     for j, fl in enumerate(flats)]
        r = ctx.interp.call_value(f, elem_args, 1, ctx.frame) if isinstance(f, FunctionHandle) \
            else ctx.interp.call_named(text_of(f), elem_args, 1, ctx.frame)
        out_flat.append(r[0] if r else MatArray.empty())
    if uniform:
        vals = np.array([v.scalar_double() if isinstance(v, MatArray) and not v.is_complex
                         else v.item() for v in out_flat])
        out = np.reshape(vals, shape, order="F")
        mc = out_flat[0].mclass if out_flat and isinstance(out_flat[0], MatArray) else "double"
        from ... import dtypes
        if mc not in ("double", "single") or out.dtype.kind == "c":
            return MatArray.from_np(out)
        return MatArray(dtypes.cast_to_class(out, mc), mc)
    data = np.empty(shape if len(shape) >= 2 else (1, n), dtype=object)
    df = data.reshape(-1, order="F" if len(shape) >= 2 else "C")
    for k in range(n):
        df[k] = out_flat[k]
    return CellArray(data)


@builtin("pagefun", category="acceleration", min_in=2, pass_ctx=True, pass_nargout=True)
def m_pagefun(f, *arrays, ctx=None, nargout=1):
    """pagefun(f, A, B, ...): apply f per 2-D page of ND inputs.
    pagefun(@mtimes, A, B) rides the batched device matmul (pagemtimes on
    the matrix units) instead of the per-page host loop."""
    arrs = list(arrays)
    from ...values import FunctionHandle
    if isinstance(f, FunctionHandle) and f.kind == "named" and \
            f.name == "mtimes" and len(arrs) == 2:
        r = ctx.interp.call_named("pagemtimes", arrs, 1, ctx.frame)
        if r:
            return r[0]
    hs = [a.host() for a in arrs]
    nd = max(h.ndim for h in hs)
    hs = [h.reshape(h.shape + (1,) * (nd - h.ndim)) for h in hs]
    page_counts = [int(np.prod(h.shape[2:])) if h.ndim > 2 else 1 for h in hs]
    npages = max(page_counts)
    outs = []
    for p in range(npages):
        elems = []
        for j, h in enumerate(hs):
            if h.ndim <= 2:
                page = h
            else:
                flat = h.reshape(h.shape[0], h.shape[1], -1, order="F")
                page = flat[:, :, p % flat.shape[2]]
            elems.append(MatArray(np.ascontiguousarray(page), arrs[j].mclass))
        r = ctx.interp.call_value(f, elems, 1, ctx.frame) if isinstance(f, FunctionHandle) \
            else ctx.interp.call_named(text_of(f), elems, 1, ctx.frame)
        outs.append(r[0].host())
    stacked = np.stack(outs, axis=2)
    if npages == 1:
        stacked = stacked[:, :, 0]
    return MatArray.from_np(stacked)


@builtin("wait", category="acceleration", min_in=0, max_in=1)
def m_wait(dev=None):
    eng = _engine(required=False)
    if eng is not None:
        eng.synchronize()
    return None


@builtin("accelInfo", category="acceleration", min_in=0, pass_ctx=True)
def m_accel_info(*args, ctx=None):
    eng = _engine(required=False)
    if eng is None:
        ctx.session.write("accelerator: none (host numpy only)\n")
        return None
    info = eng.device_info()
    tele = eng.telemetry()
    ctx.session.write(f"accelerator: {info['platform']} ({info['name']})\n")
    for k, v in tele.items():
        ctx.session.write(f"  {k}: {v}\n")
    return None


@builtin("gputimeit", category="acceleration", min_in=1, max_in=1, pass_ctx=True)
def m_gputimeit(f, ctx=None):
    """Median wall time of f() with device work forced to completion."""
    import time
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = ctx.interp.call_value(f, [], 1, ctx.frame)
        if r and isinstance(r[0], MatArray) and r[0].on_device:
            from ...accel import active_engine
            eng = active_engine()
            if eng is not None:
                eng.block_until_ready(r[0])
        times.append(time.perf_counter() - t0)
    times.sort()
    return MatArray.scalar(times[len(times) // 2])


@builtin("reset", category="acceleration", min_in=1, max_in=1)
def m_reset(dev):
    """reset(gpuDevice): drop cached executables (device arrays are
    immutable jax values; there is no mutable device state to clear)."""
    from ...accel import active_engine
    eng = active_engine()
    if eng is not None:
        eng._jit_cache.clear()
    return None
