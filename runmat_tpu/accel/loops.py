"""Whole-loop device execution: MATLAB `for` loops whose bodies are pure
device math run as ONE compiled `lax.fori_loop` kernel.

Reference parity: the StochasticEvolution idiom — the reference detects a
T-step evolution loop in MIR and folds it into a single provider call
(runmat-vm/src/compiler/core.rs:814, vm/accel/idioms/stochastic_evolution.rs:6,
backend/wgpu/shaders/stochastic_evolution.rs). Here the idiom is generalized:
any `for` body made of elementwise math, matmul, reductions and Philox RNG
draws traces into a fori_loop body, so the whole loop is one XLA program with
zero per-iteration dispatch. RNG stream parity is preserved by computing each
iteration's Philox counter as `C0 + i*blocks_per_iter + offset` inside the
kernel and advancing the session state by `T*blocks_per_iter` afterwards —
the same values every draw would have produced iteration-by-iteration.

The gate is speculative and NEVER required for correctness (the reference's
fusion-gate invariant): any unsupported opcode, builtin, shape change, or
trace failure abandons the attempt and the interpreter runs the loop normally.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from ..errors import MatError
from ..values import MatArray
from .lazy import LazyNode

# builtins that are safe to call during the trace: elementwise/broadcast math,
# reductions, and creation — everything they produce for device args stays in
# the lazy DAG
_SAFE_BUILTINS = frozenset("""
sin cos tan asin acos atan sinh cosh tanh asinh acosh atanh exp log log2
log10 log1p expm1 sqrt abs sign floor ceil round fix real imag conj angle
atan2 hypot power mod rem min max sum mean prod single double times plus
minus rdivide ldivide uminus uplus zeros ones cumsum cumprod
""".split())

_RNG_BUILTINS = frozenset(("rand", "randn"))


class _Bail(Exception):
    pass


class _Marker:
    """Payload for scalar LazyNodes whose value is loop-iteration-dependent."""

    __slots__ = ("tag", "arg")

    def __init__(self, tag: str, arg: int = 0):
        self.tag = tag      # "rng_lo" | "rng_hi" | "loopvar"
        self.arg = arg      # rng: block offset within one iteration


def try_device_loop(interp, frame, code, for_next_pc: int, iterable) -> Optional[int]:
    """Attempt to run the whole for-loop at `for_next_pc` on device.

    On success: binds final variable values into `frame`, advances the session
    RNG state, and returns the pc to resume at (just past FOR_POP).
    Returns None if the loop is ineligible — caller falls back to the normal
    interpreter path with no semantic difference.
    """
    from ..runtime import registry
    from . import active_engine
    from .lazy import topo_order

    eng = active_engine()
    if eng is None:
        return None
    if not isinstance(iterable, MatArray) or iterable.on_device:
        return None
    if iterable.mclass not in ("double", "single") or iterable.is_complex:
        return None
    h = iterable.host()
    if h.ndim != 2 or h.shape[0] != 1 or h.shape[1] < 8:
        return None
    T = int(h.shape[1])

    B = _bc()
    instrs = code.instrs
    # static pre-qualification memo: a loop site whose bytecode window is
    # ineligible never re-scans; a site whose traces keep bailing stops
    # speculating after a few entries (≙ MIR fact pre-qualification replacing
    # trial-trace-every-entry, VERDICT round-1 task 8)
    hint = code.loop_hints.get(for_next_pc)
    if hint == "never":
        return None
    # compile-time fact stamp (facts.loop_class_facts): a loop whose body
    # reads a host-only class (cell/struct/char/string) is provably
    # trace-ineligible — skip without the first trial trace
    fact = code.loop_facts.get(for_next_pc)
    if fact is not None and fact.get("never"):
        code.loop_hints[for_next_pc] = "never"
        return None
    fn_op, loopvar, done, _, _ = instrs[for_next_pc]
    if fn_op != B.FOR_NEXT or done is None:
        return None
    # window layout emitted by Compiler._for: body, CHECK_INTERRUPT, JMP back
    if instrs[done - 1][0] != B.JMP or instrs[done - 2][0] != B.CHECK_INTERRUPT:
        return None
    lo_pc, hi_pc = for_next_pc + 1, done - 2

    written: set[str] = set()
    if _scan_window(B, instrs, range(lo_pc, hi_pc), written) is None or \
            not written:
        code.loop_hints[for_next_pc] = "never"
        return None

    state = interp.session.rng
    old_cap = eng.fuse_cap
    eng.fuse_cap = 1 << 60
    try:
        eng.stats["loop_trace_attempts"] = \
            eng.stats.get("loop_trace_attempts", 0) + 1
        tr = _Trace(interp, frame, eng, registry, state, loopvar, written,
                    iterable)
        tr.run(instrs, code.consts, lo_pc, hi_pc)
        result = _build_and_run(eng, tr, T, state, h)
    except (_Bail, MatError, NotImplementedError):
        _note_bail(code, for_next_pc)
        return None
    except Exception:
        _note_bail(code, for_next_pc)
        return None
    finally:
        eng.fuse_cap = old_cap

    code.loop_hints[for_next_pc] = 0     # proven eligible: keep speculating
    for name, val in result.items():
        frame.vars[name] = val
    # MATLAB leaves the loop variable bound to its last iterate
    frame.vars[loopvar] = MatArray(h[:, -1:].copy(), iterable.mclass)
    state.advance(T * tr.rng_blocks)
    return done + 1


# --------------------------------------------------------------------------- #
# loop-program fn builders (shared with accel/warmup.py for AOT pre-compiles)
# --------------------------------------------------------------------------- #

def make_loop_fn(eng, program, roots, BPI):
    """Build the fori_loop callable for a serialized loop program."""
    jnp = eng.jnp
    jax = eng.jax

    def run(T_, c0lo, c0hi, carry0, invs, consts, itvec):
        def body(i, carry):
            env: list = [None] * len(program)
            iu = i.astype(jnp.uint32)
            for k, (kind, payload) in enumerate(program):
                if kind == "op":
                    opn, static, dt, ins, ishapes, oshape = payload
                    env[k] = eng._exec(opn, static, dt,
                                       [env[j] for j in ins], ishapes, oshape)
                elif kind == "carry":
                    env[k] = carry[payload]
                elif kind == "inv":
                    env[k] = invs[payload]
                elif kind == "const":
                    env[k] = consts[payload]
                elif kind == "rng_lo":
                    d32 = iu * jnp.uint32(BPI) + jnp.uint32(payload)
                    env[k] = c0lo + d32
                elif kind == "rng_hi":
                    d32 = iu * jnp.uint32(BPI) + jnp.uint32(payload)
                    lo = c0lo + d32
                    env[k] = c0hi + (lo < c0lo).astype(jnp.uint32)
                elif kind == "loopvar":
                    env[k] = jax.lax.dynamic_index_in_dim(
                        itvec, i, keepdims=False)
            return tuple(env[r] for r in roots)
        return jax.lax.fori_loop(0, T_, body, carry0)
    return run


def make_while_fn(eng, cond_prog, cond_root, body_prog, body_roots):
    """Build the while_loop callable for serialized cond/body programs."""
    jnp = eng.jnp
    jax = eng.jax

    def evaluate(program, roots, carry, invs, consts):
        env: list = [None] * len(program)
        for k, (kind, payload) in enumerate(program):
            if kind == "op":
                opn, static, dt, ins, ishapes, oshape = payload
                env[k] = eng._exec(opn, static, dt,
                                   [env[j] for j in ins], ishapes, oshape)
            elif kind == "carry":
                env[k] = carry[payload]
            elif kind == "inv":
                env[k] = invs[payload]
            elif kind == "const":
                env[k] = consts[payload]
        return [env[r] for r in roots]

    def run(carry0, cond_invs, body_invs, cond_consts, body_consts):
        def cond_fn(carry):
            (c,) = evaluate(cond_prog, [cond_root], carry, cond_invs,
                            cond_consts)
            return jnp.reshape(c, ()).astype(bool)

        def body_fn(carry):
            outs = evaluate(body_prog, body_roots, carry, body_invs,
                            body_consts)
            return tuple(outs)

        return jax.lax.while_loop(cond_fn, body_fn, carry0)
    return run


def _bc():
    from ..vm import bytecode as B
    return B


def _note_bail(code, pc: int, limit: int = 8) -> None:
    cur = code.loop_hints.get(pc, 0)
    if cur == "never":
        return
    cur += 1
    code.loop_hints[pc] = "never" if cur >= limit else cur


def _scan_window(B, instrs, rng, written: set, allow_store: bool = True):
    """Static eligibility scan over a bytecode window. Returns True when every
    opcode is traceable (collecting written names), None to bail."""
    for i in rng:
        op, a, b, c, d = instrs[i]
        if op == B.STORE:
            if not allow_store or b:    # display output -> host side effect
                return None
            written.add(a)
        elif op == B.STORE_INDEX:
            if not allow_store or d or c != "paren":
                return None
            written.add(a)
        elif op == B.BUILD_MAT:
            if a != ():
                return None          # only the empty [] literal is traceable
        elif op in (B.CONST, B.LOAD, B.BINOP, B.UNOP, B.MTIMES, B.TRANSPOSE,
                    B.RESOLVE_CALL, B.POP, B.DUP, B.CHECK_INTERRUPT,
                    B.COLON_VAL, B.RANGE, B.PUSH_IXCTX, B.PUSH_IXCTX_VAR,
                    B.POP_IXCTX, B.END_VAL, B.INDEX):
            if op == B.RESOLVE_CALL and (d == 2 or c > 1):
                return None
            if op == B.INDEX and b != "paren":
                return None
        else:
            return None
    return True


# --------------------------------------------------------------------------- #
# trace: mini-interpreter over the restricted body window
# --------------------------------------------------------------------------- #


class _Trace:
    def __init__(self, interp, frame, eng, registry, state, loopvar, written,
                 iterable):
        self.interp = interp
        self.frame = frame
        self.eng = eng
        self.registry = registry
        self.state = state
        self.loopvar = loopvar
        self.written = written
        self.iterable = iterable
        self.shadow: dict[str, Any] = {}
        self.carry_in: dict[str, LazyNode] = {}   # read-before-write tracers
        self.carry_init: dict[str, Any] = {}      # their initial device values
        self.rng_blocks = 0                       # Philox blocks per iteration
        self.loopvar_node: Optional[LazyNode] = None
        self.marker_nodes: list[LazyNode] = []
        self.ixctx: list = []                     # END_VAL context bases

    # -- value access -------------------------------------------------------- #

    def _resolves_to_builtin(self, name: str) -> bool:
        """True only when `name` genuinely resolves to a registry builtin in
        the tracing scope — nested functions, file-local siblings, classes,
        local/session/imported functions all shadow intrinsics (mirrors
        Interp.call_named resolution order; ≙ vm/object/resolve.rs)."""
        f = self.frame
        while f is not None:
            if f.code is not None and name in getattr(f.code, "nested", {}):
                return False
            f = f.parent
        if self.frame.code is not None:
            sibs = getattr(self.frame.code, "siblings", None)
            if sibs and name in sibs:
                return False
        if self.interp.session.classes.get(name) is not None:
            return False
        r = self.interp.resolve_function(name)
        return r is not None and r[0] == "builtin"

    def _load(self, name: str):
        if name in self.shadow:
            return self.shadow[name]
        if name == self.loopvar:
            if self.loopvar_node is None:
                dt = np.dtype(np.float64 if self.iterable.mclass == "double"
                              else np.float32)
                node = LazyNode(self.eng, "scalar", [], (), (1, 1), dt,
                                value=_Marker("loopvar"))
                self.marker_nodes.append(node)
                self.loopvar_node = node
            return MatArray.from_device(self.loopvar_node, self.iterable.mclass)
        from ..vm.interp import NOVALUE
        v = self.interp._load_name(self.frame, name)
        if v is NOVALUE:
            return NOVALUE
        if name in self.written:
            # loop-carried: replace with a tracer leaf bound to the carry slot
            if not isinstance(v, MatArray) or v.mclass not in \
                    ("double", "single", "logical"):
                raise _Bail()
            if v.on_device:
                init = self.eng.materialize(v.dev)
            else:
                from .engine import phys_shape
                ps = phys_shape(v.host().shape)
                init = self.eng.jax.device_put(
                    v.host().reshape(ps), self.eng.placement(ps))
            node = LazyNode(self.eng, "leaf", [], (), v.shape,
                            np.dtype(init.dtype), value=init)
            tracer = MatArray.from_device(node, v.mclass)
            self.carry_in[name] = node
            self.carry_init[name] = init
            self.shadow[name] = tracer
            return tracer
        if isinstance(v, MatArray) and v.on_device and v.dev.value is None:
            # Loop-invariant with a pending lazy DAG: force it ONCE here,
            # outside the loop. Otherwise the producer chain (e.g. a 400 MB
            # rand draw) is traced into the loop body and re-executes every
            # iteration — numerically identical (counters are baked) but
            # catastrophic for bandwidth. The node becomes a value-bearing
            # leaf, so the program builder passes it as a loop-invariant arg.
            self.eng.materialize(v.dev)
        return v   # loop-invariant: used as-is (scalars lift on first op)

    # -- rng ----------------------------------------------------------------- #

    def _rng(self, kind: str, args: list) -> MatArray:
        from ..values import text_of
        dims = []
        mclass = "double"
        for a in args:
            if isinstance(a, MatArray) and a.mclass == "char":
                mclass = text_of(a)
                if mclass not in ("double", "single"):
                    raise _Bail()
                continue
            if not isinstance(a, MatArray) or a.on_device or a.size != 1:
                raise _Bail()
            dims.append(int(a.host().reshape(-1)[0]))
        if not dims:
            dims = [1]
        if len(dims) == 1:
            dims = [dims[0], dims[0]]
        from ..values import normalize_shape
        shape = normalize_shape(tuple(dims))
        n = 1
        for s in shape:
            n *= s
        from ..ops import ctrng
        off = self.rng_blocks
        self.rng_blocks += ctrng.blocks_for(kind, n, mclass)
        lo = LazyNode(self.eng, "scalar", [], (), (1, 1), np.dtype(np.uint32),
                      value=_Marker("rng_lo", off))
        hi = LazyNode(self.eng, "scalar", [], (), (1, 1), np.dtype(np.uint32),
                      value=_Marker("rng_hi", off))
        self.marker_nodes += [lo, hi]
        dt = self.eng.dtype_for(mclass)
        node = self.eng._op("rng:" + kind, [lo, hi],
                            (self.state.key, n, shape, mclass), shape, dt)
        return MatArray.from_device(node, mclass)

    # -- the mini-interpreter -------------------------------------------------#

    def run(self, instrs, consts, lo_pc: int, hi_pc: int) -> None:
        from ..runtime import dispatch as D
        from ..vm.interp import NOVALUE, _collect_args, _unwrap1
        B = _bc()
        stack: list = []
        pc = lo_pc
        while pc < hi_pc:
            op, a, b, c, d = instrs[pc]
            pc += 1
            if op == B.CONST:
                stack.append(consts[a])
            elif op == B.LOAD:
                v = self._load(a)
                if v is NOVALUE:
                    raise _Bail()
                stack.append(v)
            elif op == B.STORE:
                v = _unwrap1(stack.pop(), a)
                self.shadow[a] = v
            elif op == B.BINOP:
                rhs = _unwrap1(stack.pop())
                lhs = _unwrap1(stack.pop())
                stack.append(self._op2(D.binary, a, lhs, rhs))
            elif op == B.UNOP:
                v = _unwrap1(stack.pop())
                stack.append(self._op1(D.unary, a, v))
            elif op == B.MTIMES:
                rhs = _unwrap1(stack.pop())
                lhs = _unwrap1(stack.pop())
                stack.append(self._op2(D.mtimes, None, lhs, rhs))
            elif op == B.TRANSPOSE:
                v = _unwrap1(stack.pop())
                r = D.ctranspose(v) if a else D.transpose(v)
                self._check_taint([v], r)
                stack.append(r)
            elif op == B.DUP:
                stack.append(stack[-1])
            elif op == B.POP:
                stack.pop()
            elif op == B.CHECK_INTERRUPT:
                pass
            elif op == B.BUILD_MAT:
                if a != ():
                    raise _Bail()
                stack.append(MatArray.empty())
            elif op == B.COLON_VAL:
                from ..vm.indexing import COLON
                stack.append(COLON)
            elif op == B.RANGE:
                stop = _unwrap1(stack.pop())
                step = _unwrap1(stack.pop()) if a else None
                start = _unwrap1(stack.pop())
                for v in (start, step, stop):
                    if isinstance(v, MatArray) and v.on_device:
                        raise _Bail()   # data-dependent extent
                from ..vm.interp import _make_range
                stack.append(_make_range(start, step, stop))
            elif op == B.PUSH_IXCTX:
                self.ixctx.append(stack[-1] if stack else None)
            elif op == B.PUSH_IXCTX_VAR:
                v = self._load(a)
                self.ixctx.append(None if v is NOVALUE else v)
            elif op == B.POP_IXCTX:
                self.ixctx.pop()
            elif op == B.END_VAL:
                base = self.ixctx[-1] if self.ixctx else None
                from ..vm.interp import _end_value
                stack.append(_end_value(base, a, b))
            elif op == B.INDEX:
                args = _collect_args(stack, a)
                base = _unwrap1(stack.pop())
                if self.ixctx and self.ixctx[-1] is None:
                    self.ixctx[-1] = base
                stack.append(self._index_read(base, args))
            elif op == B.STORE_INDEX:
                args = _collect_args(stack, b)
                rhs = _unwrap1(stack.pop())
                self._store_index(a, args, rhs)
            elif op == B.RESOLVE_CALL:
                name, nargs, nargout = a, b, c
                args = _collect_args(stack, nargs)
                v = self._load(name) if d != 1 else NOVALUE
                if v is not NOVALUE:
                    if nargs == 0:
                        stack.append(v)
                        continue
                    if isinstance(v, MatArray):
                        stack.append(self._index_read(v, args))
                        continue
                    raise _Bail()   # paren-indexing a non-array traced value
                if not self._resolves_to_builtin(name):
                    raise _Bail()   # user/nested/local function shadows it
                if name in _RNG_BUILTINS:
                    stack.append(self._rng(name, args))
                    continue
                if name not in _SAFE_BUILTINS:
                    raise _Bail()
                bi = self.registry.lookup(name)
                if bi is None:
                    raise _Bail()
                res = self.interp.call_builtin(bi, args, max(nargout, 1),
                                               self.frame)
                r = res[0] if res else NOVALUE
                if r is NOVALUE:
                    raise _Bail()
                self._check_taint(args, r)
                stack.append(r)
            else:
                raise _Bail()
        return stack

    # condition windows want the residual stack (the cond value)
    run_window = run

    # -- indexed reads / writes ----------------------------------------------#

    def _is_dyn(self, a) -> bool:
        """A subscript that is the raw loop variable (traced scalar)."""
        return isinstance(a, MatArray) and a.on_device and \
            a.dev is self.loopvar_node

    def _check_loopvar_bounds(self, extent: int) -> None:
        """The loop variable used as a subscript: every iterate must be an
        in-range integer, known from the host iterable at gate time."""
        if self.iterable is None:
            raise _Bail()
        h = self.iterable.host().reshape(-1)
        if not np.all(h == np.floor(h)) or h.size == 0 or \
                h.min() < 1 or h.max() > extent:
            raise _Bail()

    def _classify_args(self, base: MatArray, args: list):
        """-> (spec_args, dynamic?) where each entry is COLON | host MatArray
        | ('dyn',). Bails on anything else (device masks handled separately
        by engine.index_write)."""
        from ..vm.indexing import ColonMark
        dyn = False
        for a in args:
            if isinstance(a, ColonMark):
                continue
            if self._is_dyn(a):
                dyn = True
                continue
            if isinstance(a, MatArray) and not a.on_device and \
                    a.mclass != "logical":
                continue
            return None, False
        return args, dyn

    def _index_read(self, base, args: list):
        if not isinstance(base, MatArray) or not args:
            raise _Bail()
        eng = self.eng
        spec_args, dyn = self._classify_args(base, args)
        if spec_args is None:
            raise _Bail()
        if not dyn:
            if not base.on_device:
                # loop-invariant host read: plain interpreter indexing
                from ..vm import indexing as IXM
                return IXM.read_paren(base, args)
            r = eng.index_read(base, args)
            if r is None:
                r = eng.index_read_general(base, args)
            if r is None:
                raise _Bail()
            return r
        # dynamic subscript: lower to a traced gather
        if not base.on_device:
            if base.mclass not in ("double", "single", "logical"):
                raise _Bail()
            node = eng._lift(base, base.host().dtype)
            base = MatArray.from_device(node, base.mclass)
        nb = base.dev
        shape = nb.shape
        from ..vm.indexing import ColonMark
        if len(args) == 1:
            n = 1
            for s in shape:
                n *= s
            self._check_loopvar_bounds(n)
            node = eng._op("gather1d", [nb, args[0].dev], (), (1, 1),
                           nb.dtype)
            return MatArray.from_device(node, base.mclass)
        if len(args) != len(shape):
            raise _Bail()
        inputs = [nb]
        spec = []
        out_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                out_shape.append(shape[k])
            elif self._is_dyn(a):
                self._check_loopvar_bounds(shape[k])
                spec.append(("d", len(inputs)))
                inputs.append(a.dev)
                out_shape.append(1)
            else:
                iv = eng._index_vec(a, shape[k])
                if iv is None:
                    raise _Bail()
                spec.append(("s", len(inputs)))
                inputs.append(eng._idx_leaf(iv))
                out_shape.append(iv.size)
        from ..values import normalize_shape
        node = eng._op("gatherN", inputs, (tuple(spec),),
                       normalize_shape(out_shape), nb.dtype)
        return MatArray.from_device(node, base.mclass)

    def _store_index(self, name: str, args: list, rhs) -> None:
        if not isinstance(rhs, MatArray) or not args:
            raise _Bail()
        base = self._load(name)
        from ..vm.interp import NOVALUE
        if base is NOVALUE or not isinstance(base, MatArray):
            raise _Bail()
        eng = self.eng
        if not base.on_device:
            raise _Bail()   # written vars are lifted by _load; anything else
        spec_args, dyn = self._classify_args(base, args)
        if spec_args is None:
            # device logical mask with scalar rhs is handled by index_write
            res = eng.index_write(base, args, rhs)
            if res is None:
                raise _Bail()
            self.shadow[name] = res
            return
        if not dyn:
            res = eng.index_write(base, args, rhs)
            if res is None:
                raise _Bail()
            self.shadow[name] = res
            return
        if rhs.mclass not in ("double", "single", "logical") or \
                rhs.is_complex != base.is_complex:
            raise _Bail()
        nb = base.dev
        shape = nb.shape
        from ..vm.indexing import ColonMark
        rn = eng._lift(rhs, nb.dtype) if rhs.size != 1 or rhs.on_device \
            else eng._scalar_node(rhs._host.reshape(-1)[0], nb.dtype)
        if len(args) == 1:
            n = 1
            for s in shape:
                n *= s
            if rhs.size != 1:
                raise _Bail()
            self._check_loopvar_bounds(n)
            node = eng._op("scatter1d", [nb, args[0].dev, rn], (), shape,
                           nb.dtype)
            self.shadow[name] = MatArray.from_device(node, base.mclass)
            return
        if len(args) != len(shape):
            raise _Bail()
        inputs = [nb]
        spec = []
        sel_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                sel_shape.append(shape[k])
            elif self._is_dyn(a):
                self._check_loopvar_bounds(shape[k])
                spec.append(("d", len(inputs)))
                inputs.append(a.dev)
                sel_shape.append(1)
            else:
                iv = eng._index_vec(a, shape[k], unique_required=True)
                if iv is None:
                    raise _Bail()
                spec.append(("s", len(inputs)))
                inputs.append(eng._idx_leaf(iv))
                sel_shape.append(iv.size)
        nelem = 1
        for s in sel_shape:
            nelem *= s
        if rhs.size not in (1, nelem):
            raise _Bail()
        inputs.append(rn)
        node = eng._op("scatterN", inputs,
                       (tuple(spec), tuple(sel_shape), rhs.size == 1),
                       shape, nb.dtype)
        self.shadow[name] = MatArray.from_device(node, base.mclass)

    def _op2(self, fn, opname, lhs, rhs):
        r = fn(opname, lhs, rhs) if opname is not None else fn(lhs, rhs)
        self._check_taint([lhs, rhs], r)
        return r

    def _op1(self, fn, opname, v):
        r = fn(opname, v)
        self._check_taint([v], r)
        return r

    def _check_taint(self, args, result) -> None:
        """Any op consuming a device value must produce a device value; a host
        escape would bake iteration-0 data into every iteration."""
        if any(isinstance(x, MatArray) and x.on_device for x in args):
            if not (isinstance(result, MatArray) and result.on_device):
                raise _Bail()


# --------------------------------------------------------------------------- #
# build + run the fori_loop
# --------------------------------------------------------------------------- #


def _build_and_run(eng, tr: _Trace, T: int, state, iter_host: np.ndarray) -> dict:
    from .engine import phys_shape
    from .lazy import topo_order

    names = sorted(tr.written)
    finals = {}
    for name in names:
        v = tr.shadow.get(name)
        if not (isinstance(v, MatArray) and v.on_device):
            raise _Bail()
        finals[name] = v

    if tr.rng_blocks and T * tr.rng_blocks >= (1 << 31):
        raise _Bail()

    # merged topo over all roots
    order: list[LazyNode] = []
    seen: set[int] = set()
    for name in names:
        for n in topo_order(finals[name].dev):
            if id(n) not in seen:
                seen.add(id(n))
                order.append(n)
    index = {id(n): i for i, n in enumerate(order)}

    carry_slot = {name: k for k, name in enumerate(names)}
    carried_leaf = {id(node): carry_slot[name]
                    for name, node in tr.carry_in.items()
                    if name in carry_slot}
    # a read-carried var whose tracer leaf no longer feeds its own final value
    # is still fine — the leaf just binds the carry slot wherever it's used

    program = []           # (kind, payload)
    inv_values = []        # loop-invariant device leaves, passed as args
    const_values = []      # host scalar consts, passed as TRACED args — the
    #                        cache key hashes only their dtype, so values must
    #                        never be baked into the compiled closure
    key_parts: list = []   # structural key (T excluded: it's a traced arg)
    for n in order:
        if n.cplx:
            # split-plane complex nodes carry semantics the 6-field loop
            # program can't express — bail to the interpreter (correctness
            # never requires the loop fold)
            raise _Bail()
        if n.op == "scalar":
            val = n.value
            if isinstance(val, _Marker):
                program.append((val.tag, val.arg))
                key_parts.append(("M", val.tag, val.arg, str(n.dtype)))
            else:
                program.append(("const", len(const_values)))
                const_values.append(np.asarray(val, dtype=n.dtype))
                key_parts.append(("C", str(n.dtype)))
        elif n.value is not None:
            if id(n) in carried_leaf:
                program.append(("carry", carried_leaf[id(n)]))
                key_parts.append(("K", carried_leaf[id(n)],
                                  tuple(n.value.shape), str(n.value.dtype)))
            else:
                program.append(("inv", len(inv_values)))
                inv_values.append(n.value)
                key_parts.append(("I", tuple(n.value.shape), str(n.value.dtype)))
        else:
            ins = tuple(index[id(i)] for i in n.inputs)
            ishapes = tuple(i.shape for i in n.inputs)
            program.append(("op", (n.op, n.static, n.dtype, ins, ishapes,
                                   n.shape)))
            key_parts.append((n.op, n.static, ins, str(n.dtype), n.shape))
    roots = [index[id(finals[name].dev)] for name in names]
    key_parts.append(tuple(roots))
    key_parts.append(("carry_shapes",
                      tuple((tuple(finals[n].dev.shape), str(finals[n].dev.dtype))
                            for n in names)))
    key = ("device_loop", tuple(key_parts))

    BPI = tr.rng_blocks
    jnp = eng.jnp
    jax = eng.jax

    cached = eng._jit_cache.get(key)
    if cached is None:
        cached = jax.jit(make_loop_fn(eng, program, roots, BPI))
        eng._jit_cache[key] = cached
        eng.stats["compiles"] += 1
        fresh_compile = True
    else:
        fresh_compile = False
        eng.stats["cache_hits"] += 1

    # initial carry: read-carried vars start from their live values;
    # write-before-read vars get typed zero placeholders (never read).
    # Placeholders and the iterable vector are cached per loop shape — each
    # fresh device array is its own dispatch.
    arg_cache = getattr(eng, "_loop_arg_cache", None)
    if arg_cache is None:
        arg_cache = eng._loop_arg_cache = {}
    carry0 = []
    for name in names:
        init = tr.carry_init.get(name)
        root = finals[name].dev
        ps = phys_shape(tuple(root.shape))
        if init is not None and tuple(init.shape) == ps and \
                init.dtype == root.dtype:
            carry0.append(init)
        elif init is not None:
            raise _Bail()   # carried shape/dtype changes across iterations
        else:
            zk = ("zeros", ps, str(root.dtype))
            z = arg_cache.get(zk)
            if z is None:
                z = jnp.zeros(ps, dtype=root.dtype)
                if eng.mesh is not None:
                    z = jax.device_put(z, eng.placement(ps))
                arg_cache[zk] = z
            carry0.append(z)

    c0 = state.counter
    it_np = iter_host.reshape(-1).astype(
        np.float64 if tr.iterable.mclass == "double" else np.float32)
    ik = ("itvec", it_np.dtype.str, it_np.shape, it_np.tobytes())
    itvec = arg_cache.get(ik)
    if itvec is None:
        if len(arg_cache) > 256:
            arg_cache.clear()
        itvec = arg_cache[ik] = jax.device_put(
            it_np, eng.placement(tuple(it_np.shape)))
    if fresh_compile:
        from . import warmup as _wu
        _wu.record_loop(eng, program, roots, BPI, carry0, inv_values,
                        const_values, itvec)
    import time as _time
    _t0 = _time.perf_counter()
    out = cached(np.int32(T), np.uint32(c0 & 0xFFFFFFFF),
                 np.uint32((c0 >> 32) & 0xFFFFFFFF),
                 tuple(carry0), tuple(inv_values), tuple(const_values), itvec)
    eng.stats["dispatches"] += 1
    eng.dispatch_seq += 1
    eng.record_launch("device_loop",
                      [p[1][0] for p in program if p[0] == "op"],
                      (_time.perf_counter() - _t0) * 1e3,
                      sum(int(getattr(o, "nbytes", 0)) for o in out))

    result = {}
    for k, name in enumerate(names):
        root = finals[name].dev
        node = LazyNode(eng, "leaf", [], (), tuple(root.shape), root.dtype,
                        value=out[k])
        node.dispatch_id = eng.dispatch_seq
        result[name] = MatArray.from_device(node, finals[name].mclass)
    return result


# --------------------------------------------------------------------------- #
# while-loop device idiom
# --------------------------------------------------------------------------- #

def try_device_while(interp, frame, code, marker_pc: int, jf_pc: int,
                     end_pc: int):
    """Attempt to run the whole `while` loop starting at `marker_pc` as ONE
    `lax.while_loop` on device (the data-dependent-trip-count extension of
    the for-loop idiom; iterative solvers like `while err > tol` compile to
    a single XLA program instead of one dispatch per iteration).

    v1 eligibility: pure device math in condition and body, no RNG draws
    (counters would become data-dependent), every written variable already
    defined before the loop (so a zero-trip loop leaves the workspace
    exactly as the interpreter would). Returns the resume pc on success,
    None to fall back to plain interpretation."""
    from ..runtime import registry
    from . import active_engine
    from .lazy import topo_order

    eng = active_engine()
    if eng is None:
        return None
    B = _bc()
    instrs = code.instrs
    if jf_pc is None or end_pc is None:
        return None
    hint = code.loop_hints.get(marker_pc)
    if hint == "never":
        return None
    if instrs[end_pc - 1][0] != B.JMP or instrs[end_pc - 2][0] != B.CHECK_INTERRUPT:
        return None
    cond_lo, cond_hi = marker_pc + 1, jf_pc
    body_lo, body_hi = jf_pc + 1, end_pc - 2

    written: set[str] = set()
    if _scan_window(B, instrs, range(cond_lo, cond_hi), written,
                    allow_store=False) is None:
        code.loop_hints[marker_pc] = "never"
        return None                  # condition with a side effect: bail
    if _scan_window(B, instrs, range(body_lo, body_hi), written) is None:
        code.loop_hints[marker_pc] = "never"
        return None
    for i in [*range(cond_lo, cond_hi), *range(body_lo, body_hi)]:
        op, a, b, c, d = instrs[i]
        if op == B.RESOLVE_CALL and a in _RNG_BUILTINS:
            code.loop_hints[marker_pc] = "never"
            return None              # v1: no data-dependent RNG counters
    if not written:
        if os.environ.get("RUNMAT_TPU_DEBUG_LOOPS"):
            print("[device_while] bail: no written vars")
        return None
    # zero-trip safety: every written var must already exist with a carried
    # type so skipping the loop leaves identical state
    from ..vm.interp import NOVALUE
    for name in written:
        v = interp._load_name(frame, name)
        if v is NOVALUE or not isinstance(v, MatArray) or \
                v.mclass not in ("double", "single", "logical"):
            if os.environ.get("RUNMAT_TPU_DEBUG_LOOPS"):
                print(f"[device_while] bail: zero-trip var {name!r} = "
                      f"{type(v).__name__}")
            return None

    state = interp.session.rng
    old_cap = eng.fuse_cap
    eng.fuse_cap = 1 << 60
    try:
        tr = _Trace(interp, frame, eng, registry, state, None, written, None)
        cond_stack = tr.run_window(instrs, code.consts, cond_lo, cond_hi)
        if len(cond_stack) != 1:
            raise _Bail()
        cond_v = cond_stack[0]
        if not (isinstance(cond_v, MatArray) and cond_v.on_device
                and cond_v.size == 1):
            raise _Bail()            # host-computed condition: nothing to gain
        tr.run(instrs, code.consts, body_lo, body_hi)
        if tr.rng_blocks:
            raise _Bail()
        result = _build_and_run_while(eng, tr, cond_v)
    except (_Bail, MatError, NotImplementedError):
        _note_bail(code, marker_pc)
        if os.environ.get("RUNMAT_TPU_DEBUG_LOOPS"):
            import traceback
            traceback.print_exc()
        return None
    except Exception:
        _note_bail(code, marker_pc)
        if os.environ.get("RUNMAT_TPU_DEBUG_LOOPS"):
            import traceback
            traceback.print_exc()
        return None
    finally:
        eng.fuse_cap = old_cap

    if os.environ.get("RUNMAT_TPU_DEBUG_LOOPS"):
        print(f"[device_while] took over loop at pc {marker_pc}: "
              f"carries {sorted(result)}")
    for name, val in result.items():
        interp._store_name(frame, name, val)
    return end_pc


def _build_and_run_while(eng, tr: _Trace, cond_v: MatArray) -> dict:
    from .engine import phys_shape
    from .lazy import topo_order

    names = sorted(tr.written)
    finals = {}
    for name in names:
        v = tr.shadow.get(name)
        if not (isinstance(v, MatArray) and v.on_device):
            raise _Bail()
        finals[name] = v
        if name not in tr.carry_init:
            raise _Bail()            # zero-trip safety (checked above too)

    carry_slot = {name: k for k, name in enumerate(names)}
    carried_leaf = {id(node): carry_slot[name]
                    for name, node in tr.carry_in.items()
                    if name in carry_slot}

    def build(roots: list):
        order: list[LazyNode] = []
        seen: set[int] = set()
        for r in roots:
            for n in topo_order(r):
                if id(n) not in seen:
                    seen.add(id(n))
                    order.append(n)
        index = {id(n): i for i, n in enumerate(order)}
        program = []
        inv_values = []
        const_values = []   # traced args — key hashes dtype only, never value
        key_parts: list = []
        for n in order:
            if n.cplx:
                raise _Bail()        # split-plane complex: interpreter path
            if n.op == "scalar":
                if isinstance(n.value, _Marker):
                    raise _Bail()    # loopvar/rng markers: not valid in while
                program.append(("const", len(const_values)))
                const_values.append(np.asarray(n.value, dtype=n.dtype))
                key_parts.append(("C", str(n.dtype)))
            elif n.value is not None:
                if id(n) in carried_leaf:
                    program.append(("carry", carried_leaf[id(n)]))
                    key_parts.append(("K", carried_leaf[id(n)],
                                      tuple(n.value.shape), str(n.value.dtype)))
                else:
                    program.append(("inv", len(inv_values)))
                    inv_values.append(n.value)
                    key_parts.append(("I", tuple(n.value.shape),
                                      str(n.value.dtype)))
            else:
                ins = tuple(index[id(i)] for i in n.inputs)
                ishapes = tuple(i.shape for i in n.inputs)
                program.append(("op", (n.op, n.static, n.dtype, ins, ishapes,
                                       n.shape)))
                key_parts.append((n.op, n.static, ins, str(n.dtype), n.shape))
        root_idx = [index[id(r)] for r in roots]
        return program, inv_values, const_values, key_parts, root_idx

    cond_prog, cond_inv, cond_const, cond_key, (cond_root,) = build([cond_v.dev])
    body_prog, body_inv, body_const, body_key, body_roots = build(
        [finals[n].dev for n in names])

    key = ("device_while", tuple(cond_key), tuple(body_key),
           tuple(body_roots), cond_root,
           tuple((tuple(finals[n].dev.shape), str(finals[n].dev.dtype))
                 for n in names))

    jnp = eng.jnp
    jax = eng.jax
    cached = eng._jit_cache.get(key)
    if cached is None:
        cached = jax.jit(make_while_fn(eng, cond_prog, cond_root, body_prog,
                                       body_roots))
        eng._jit_cache[key] = cached
        eng.stats["compiles"] += 1
    else:
        eng.stats["cache_hits"] += 1

    carry0 = tuple(tr.carry_init[n] for n in names)
    import time as _time
    _t0 = _time.perf_counter()
    out = cached(carry0, tuple(cond_inv), tuple(body_inv),
                 tuple(cond_const), tuple(body_const))
    eng.stats["dispatches"] += 1
    eng.dispatch_seq += 1
    eng.record_launch("device_while",
                      [p[1][0] for p in body_prog if p[0] == "op"],
                      (_time.perf_counter() - _t0) * 1e3,
                      sum(int(getattr(o, "nbytes", 0)) for o in out))

    result = {}
    for k, name in enumerate(names):
        root = finals[name].dev
        node = LazyNode(eng, "leaf", [], (), tuple(root.shape), root.dtype,
                        value=out[k])
        node.dispatch_id = eng.dispatch_seq
        result[name] = MatArray.from_device(node, finals[name].mclass)
    return result
