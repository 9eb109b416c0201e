"""dlarray reverse-mode autodiff: jax.grad over the engine's lazy op-DAG.

Reference parity: the tape-based autodiff of the reference's deep-learning
toolbox (runmat-runtime/src/builtins/deep_learning/autodiff.rs:12-40 —
thread-local tape with per-op Node kinds). Redesign on JAX: the engine's
lazy DAG *is* the tape. dlfeval runs the MATLAB function with an uncapped
fusion window so every op lands in one DAG; dlgradient converts the DAG to a
traced jax function and lets jax.grad/XLA generate the backward pass — no
hand-written VJP rules, and the whole forward+backward compiles to one device
program.
"""

from __future__ import annotations

import numpy as np

from ..errors import MatError
from ..values import MatArray


def grad(loss: MatArray, wrt: list) -> list:
    """d(loss)/d(wrt_i) for a scalar device-resident loss whose DAG contains
    each wrt value as a leaf."""
    from ..accel import active_engine
    from ..accel.engine import phys_shape
    from ..accel.lazy import LazyNode, topo_order

    eng = active_engine()
    if eng is None:
        raise MatError("MATLAB:dlgradient:noEngine",
                       "dlgradient requires the accel engine.")
    if not (isinstance(loss, MatArray) and loss.on_device and loss.size == 1):
        raise MatError("MATLAB:dlgradient:scalarLoss",
                       "dlgradient requires a scalar traced (dlarray) loss. "
                       "Make sure the loss was computed from dlarray inputs "
                       "inside dlfeval and was not gathered.")
    for w in wrt:
        if not (isinstance(w, MatArray) and w.on_device
                and w.dev.value is not None):
            raise MatError("MATLAB:dlgradient:untraced",
                           "dlgradient targets must be dlarray leaves that "
                           "participated in the loss computation.")

    order = topo_order(loss.dev)
    index = {id(n): i for i, n in enumerate(order)}
    for w in wrt:
        if id(w.dev) not in index:
            raise MatError("MATLAB:dlgradient:unusedVariable",
                           "A dlgradient target does not participate in the "
                           "traced loss (was it used inside dlfeval?).")

    program = eng._build_program(order)
    wrt_ids = {id(w.dev): k for k, w in enumerate(wrt)}
    # partition the DAG leaves into differentiated / constant
    wrt_slot: dict[int, int] = {}       # program index -> wrt arg position
    const_leaves = []
    scalars = []
    li = 0
    for i, n in enumerate(order):
        if n.op == "scalar":
            scalars.append(np.asarray(n.value, dtype=n.dtype))
        elif n.value is not None:
            if id(n) in wrt_ids:
                wrt_slot[i] = wrt_ids[id(n)]
            else:
                const_leaves.append(n.value)
            li += 1

    key = ("dlgrad", tuple(
        (p[0], p[1], str(p[2]), p[3], p[4], p[5],
         wrt_slot.get(i, -1)) for i, p in enumerate(program)))
    cached = eng._jit_cache.get(key)
    if cached is None:
        jnp = eng.jnp

        def fwd(wrt_args, const_args, scalar_args):
            env: list = [None] * len(program)
            ci = si = 0
            for i, (op, static, dt, in_idx, ishapes, oshape) in enumerate(program):
                if op == "__leaf__":
                    if i in wrt_slot:
                        env[i] = wrt_args[wrt_slot[i]]
                    else:
                        env[i] = const_args[ci]
                        ci += 1
                elif op == "scalar":
                    env[i] = scalar_args[si]
                    si += 1
                else:
                    env[i] = eng._exec(op, static, dt, [env[j] for j in in_idx],
                                       ishapes, oshape)
            out = env[-1]
            return out.reshape(()).astype(jnp.float32 if out.dtype ==
                                          np.float32 else out.dtype)

        cached = eng.jax.jit(eng.jax.grad(fwd, argnums=0))
        eng._jit_cache[key] = cached
        eng.stats["compiles"] += 1
    else:
        eng.stats["cache_hits"] += 1

    wrt_args = tuple(w.dev.value for w in wrt)
    # const leaf extraction must match fwd's consumption order
    grads = cached(wrt_args, tuple(const_leaves), tuple(scalars))
    eng.stats["dispatches"] += 1
    out = []
    for w, g in zip(wrt, grads):
        node = LazyNode(eng, "leaf", [], (), tuple(w.shape), np.dtype(g.dtype),
                        value=g)
        ga = MatArray.from_device(node, w.mclass)
        ga.dl = True
        out.append(ga)
    return out
