"""Lazy operation DAG: the device fusion plan.

Reference parity: runmat-accelerate's AccelGraph + fusion planner + WGSL codegen
(crates/runmat-accelerate/src/{graph.rs,fusion.rs:94-120,1513-1765}). Where the
reference detects fusible spans in bytecode and emits WGSL kernels, here every
device-resident value *is* a node in a lazy DAG; materialization traces the DAG
into one jax computation compiled under jax.jit (XLA performs the elementwise/
reduction fusion the reference hand-generates). The jit cache keyed by DAG
structure ≙ the reference's fusion-plan cache keyed by graph hash
(fusion.rs:684-703) and the wgpu pipeline cache.

Host scalars enter as *traced parameters* (hashed by dtype, not value), so loop
iterations with varying constants hit the same compiled executable — the analog
of the reference binding constants through uniform buffers.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

# Node op-count cap before forced materialization: bounds trace size and
# compile time while leaving whole benchmark pipelines (10-60 ops) fused.
DEFAULT_FUSE_CAP = 96


class LazyNode:
    """One value in the device DAG. kind: 'leaf' (concrete jax.Array),
    'scalar' (traced host scalar parameter), or an op name."""

    __slots__ = ("op", "inputs", "static", "shape", "dtype", "_value",
                 "n_ops", "engine", "pinned", "dispatch_id", "cplx",
                 "__weakref__")

    def __init__(self, engine, op: str, inputs: list, static: tuple,
                 shape: tuple, dtype, value: Any = None, cplx: bool = False):
        self.engine = engine
        self.op = op
        self.inputs = inputs
        self.static = static
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.pinned = False         # workspace-bound: materialize alongside any root
        self.dispatch_id = None     # engine dispatch seq that produced .value
        # split-plane complex: dtype is REAL (f32/f64) but the physical value
        # carries a leading (2,) plane axis [re, im] — the representation
        # complex values take on platforms without complex dtype transfers
        # (accel/cplx.py). Logical shape/class are unchanged.
        self.cplx = bool(cplx)
        self.value = value          # concrete jax.Array for leaves / after force
        self.n_ops = (0 if op in ("leaf", "scalar")
                      else 1 + sum(i.n_ops for i in inputs))

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        """Setting a concrete device buffer enrolls this node in the engine's
        HBM residency ledger (≙ mark_residency, accelerate-api lib.rs:67);
        scalar nodes carry host payloads and stay out of the ledger."""
        self._value = v
        if v is not None and self.op != "scalar":
            pool = getattr(self.engine, "residency", None)
            if pool is not None:
                pool.track(self)

    # --- duck-typed device-handle protocol used by MatArray ----------------- #

    @property
    def is_complex(self) -> bool:
        return self.dtype.kind == "c" or self.cplx

    def gather(self) -> np.ndarray:
        """Materialize and transfer to host (≙ provider.download).
        device_get is the one D2H path used. Device values are stored in
        PHYSICAL shape (vectors squeezed to rank-1, see engine.phys_shape);
        reshape back to the logical MATLAB shape here at the host boundary."""
        h = self.engine.jax.device_get(self.engine.materialize(self))
        # dispatches complete in program order on a device stream: a blocking
        # gather of this node proves every dispatch with id <= this node's is
        # finished (used by benchmarks to skip redundant sync round trips)
        if self.dispatch_id is not None:
            eng = self.engine
            eng.gathered_seq = max(eng.gathered_seq, self.dispatch_id)
        if self.cplx:
            from .cplx import combine_to_host
            h = combine_to_host(h)
        return h if h.shape == self.shape else h.reshape(self.shape)

    def concrete(self):
        """Materialize on device without host transfer."""
        return self.engine.materialize(self)

    def __repr__(self):  # pragma: no cover
        return f"Lazy<{self.op} {self.shape} {self.dtype} ops={self.n_ops}>"


def topo_order(root: LazyNode) -> list[LazyNode]:
    seen: dict[int, LazyNode] = {}
    order: list[LazyNode] = []
    stack: list[tuple[LazyNode, bool]] = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen[id(node)] = node
        stack.append((node, True))
        if node.value is None:
            for i in node.inputs:
                stack.append((i, False))
    return order


def structure_key(root: LazyNode) -> tuple:
    """Hashable structural fingerprint of the DAG reachable from root.
    Leaves contribute (shape, dtype); scalar params contribute dtype only;
    op nodes contribute (op, static args, input slots)."""
    order = topo_order(root)
    index = {id(n): i for i, n in enumerate(order)}
    parts = []
    for n in order:
        if n.op == "scalar":
            parts.append(("S", str(n.dtype), n.cplx))
        elif n.value is not None:
            parts.append(("L", n.shape, str(n.dtype), n.cplx))
        else:
            parts.append((n.op, n.static, tuple(index[id(i)] for i in n.inputs),
                          str(n.dtype), n.shape, n.cplx))
    return tuple(parts)
