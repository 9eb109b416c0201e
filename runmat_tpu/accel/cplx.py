"""Split-plane complex kernels: complex values as stacked (re, im) planes.

An opt-in representation (RUNMAT_TPU_COMPLEX_NATIVE=0; VERDICT r4 #2) for
a backend whose complex dtypes fail at program boundaries, which is how the
runtime's first accelerator behaved. The GPU and CPU backends take complex
dtypes natively and use them by default. In this mode no complex dtype is
transferred at all: a complex device value is ONE real array with a leading
plane axis:

    z  ->  stack([real(z), imag(z)])      physical shape (2,) + phys_shape

and every complex op is expressed in real arithmetic on the planes. This
is exactly the reference's interleaved ComplexTensor storage idea
(runmat-accelerate-api/src/lib.rs:247-251, backend/wgpu/shaders/
elementwise.rs) with planes (not interleaving), so each plane stays
contiguous, and XLA fuses the two-plane expressions as aggressively as a
native complex op.

All kernels take plane-stacked arrays (`a[0]`=re, `a[1]`=im) or plain real
arrays, flagged by the caller. They run inside the engine's fused-DAG jit
traces — nothing here dispatches.
"""

from __future__ import annotations

import numpy as np


def planes_from_host(h: np.ndarray) -> np.ndarray:
    """Host complex ndarray -> (2,)+shape real plane stack (C-contiguous)."""
    r = np.ascontiguousarray(h.real)
    i = np.ascontiguousarray(h.imag)
    return np.stack([r, i])


def combine_to_host(p: np.ndarray) -> np.ndarray:
    """(2,)+shape real plane stack -> host complex ndarray."""
    dt = np.complex64 if p.dtype == np.float32 else np.complex128
    return (p[0] + 1j * p[1]).astype(dt)


def lift(jnp, a, is_cplx: bool):
    """Return (re, im) views for an operand; real operands get a scalar-0
    imag plane that broadcasts (XLA folds the dead zero arithmetic)."""
    if is_cplx:
        return a[0], a[1]
    return a, jnp.zeros((), a.dtype)


def pack(jnp, re, im):
    re, im = jnp.broadcast_arrays(re, im)
    return jnp.stack([re, im])


# --------------------------------------------------------------------------- #
# binary arithmetic
# --------------------------------------------------------------------------- #

def add(jnp, ar, ai, br, bi):
    return ar + br, ai + bi


def sub(jnp, ar, ai, br, bi):
    return ar - br, ai - bi


def mul(jnp, ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def div(jnp, ar, ai, br, bi):
    """Smith's algorithm: scale by the larger of |br|,|bi| so intermediate
    squares cannot overflow/underflow where the true quotient is fine."""
    swap = jnp.abs(br) < jnp.abs(bi)
    u = jnp.where(swap, bi, br)       # larger-magnitude component
    v = jnp.where(swap, br, bi)       # smaller
    t = v / u
    den = u + v * t
    # quotient for br-dominant: ((ar + ai t) + i (ai - ar t)) / den
    # for bi-dominant (swap):   ((ar t + ai) + i (ai t - ar)) / den
    re = jnp.where(swap, ar * t + ai, ar + ai * t) / den
    im = jnp.where(swap, ai * t - ar, ai - ar * t) / den
    return re, im


def _log_planes(jnp, ar, ai):
    return jnp.log(jnp.hypot(ar, ai)), jnp.arctan2(ai, ar)


def _exp_planes(jnp, ar, ai):
    e = jnp.exp(ar)
    return e * jnp.cos(ai), e * jnp.sin(ai)


def power(jnp, ar, ai, br, bi):
    """z ^ w = exp(w * log z); 0^0 pinned to 1, 0^w to 0 for re(w)>0."""
    lr, li = _log_planes(jnp, ar, ai)
    pr, pi = mul(jnp, br, bi, lr, li)
    re, im = _exp_planes(jnp, pr, pi)
    zero_base = (ar == 0) & (ai == 0)
    zero_exp = (br == 0) & (bi == 0)
    re = jnp.where(zero_base & zero_exp, 1.0,
                   jnp.where(zero_base & (br > 0), 0.0, re))
    im = jnp.where(zero_base & (zero_exp | (br > 0)), 0.0, im)
    return re, im


def eq(jnp, ar, ai, br, bi):
    return (ar == br) & (ai == bi)


def ne(jnp, ar, ai, br, bi):
    return (ar != br) | (ai != bi)


BINARY = {
    "add": add,
    "sub": sub,
    "mul": mul,
    "div": div,
    "ldiv": lambda jnp, ar, ai, br, bi: div(jnp, br, bi, ar, ai),
    "pow": power,
}

# MATLAB relational <,>,<=,>= on complex compare REAL PARTS only; == and ~=
# compare the full value. Handled by the caller: relationals take the re
# planes through the real compare table; these two need both planes.
COMPARE = {"eq": eq, "ne": ne}


# --------------------------------------------------------------------------- #
# unary
# --------------------------------------------------------------------------- #

def _sqrt(jnp, ar, ai):
    """Principal square root via the stable half-angle form."""
    m = jnp.hypot(ar, ai)
    re = jnp.sqrt((m + ar) * 0.5)
    im_mag = jnp.sqrt(jnp.maximum(m - ar, 0.0) * 0.5)
    im = jnp.where(ai < 0, -im_mag, im_mag)
    return re, im


def _sign(jnp, ar, ai):
    m = jnp.hypot(ar, ai)
    safe = jnp.where(m == 0, 1.0, m)
    return jnp.where(m == 0, 0.0, ar / safe), \
        jnp.where(m == 0, 0.0, ai / safe)


def _sin(jnp, ar, ai):
    return jnp.sin(ar) * jnp.cosh(ai), jnp.cos(ar) * jnp.sinh(ai)


def _cos(jnp, ar, ai):
    return jnp.cos(ar) * jnp.cosh(ai), -jnp.sin(ar) * jnp.sinh(ai)


def _tan(jnp, ar, ai):
    sr, si = _sin(jnp, ar, ai)
    cr, ci = _cos(jnp, ar, ai)
    return div(jnp, sr, si, cr, ci)


def _sinh(jnp, ar, ai):
    return jnp.sinh(ar) * jnp.cos(ai), jnp.cosh(ar) * jnp.sin(ai)


def _cosh(jnp, ar, ai):
    return jnp.cosh(ar) * jnp.cos(ai), jnp.sinh(ar) * jnp.sin(ai)


def _tanh(jnp, ar, ai):
    sr, si = _sinh(jnp, ar, ai)
    cr, ci = _cosh(jnp, ar, ai)
    return div(jnp, sr, si, cr, ci)


# complex -> complex: (jnp, ar, ai) -> (re, im)
UNARY_C2C = {
    "neg": lambda jnp, ar, ai: (-ar, -ai),
    "uplus": lambda jnp, ar, ai: (ar, ai),
    "conj": lambda jnp, ar, ai: (ar, -ai),
    "square": lambda jnp, ar, ai: mul(jnp, ar, ai, ar, ai),
    "reciprocal": lambda jnp, ar, ai: div(jnp, jnp.ones((), ar.dtype),
                                          jnp.zeros((), ar.dtype), ar, ai),
    "sqrt": _sqrt,
    "exp": _exp_planes,
    "log": _log_planes,
    "log2": lambda jnp, ar, ai: tuple(v / np.log(2.0)
                                      for v in _log_planes(jnp, ar, ai)),
    "log10": lambda jnp, ar, ai: tuple(v / np.log(10.0)
                                       for v in _log_planes(jnp, ar, ai)),
    "sign": _sign,
    "sin": _sin, "cos": _cos, "tan": _tan,
    "sinh": _sinh, "cosh": _cosh, "tanh": _tanh,
}

# complex -> real: (jnp, ar, ai) -> plane
UNARY_C2R = {
    "abs": lambda jnp, ar, ai: jnp.hypot(ar, ai),
    "real": lambda jnp, ar, ai: ar,
    "imag": lambda jnp, ar, ai: ai,
    "angle": lambda jnp, ar, ai: jnp.arctan2(ai, ar),
    "isnan": lambda jnp, ar, ai: jnp.isnan(ar) | jnp.isnan(ai),
    "isinf": lambda jnp, ar, ai: (jnp.isinf(ar) | jnp.isinf(ai))
    & ~(jnp.isnan(ar) | jnp.isnan(ai)),
    "isfinite": lambda jnp, ar, ai: jnp.isfinite(ar) & jnp.isfinite(ai),
}


def matmul(jnp, ar, ai, br, bi, mm):
    """Complex GEMM as 3 real GEMMs (Karatsuba / Strassen-for-complex):
        P1 = Ar Br, P2 = Ai Bi, P3 = (Ar+Ai)(Br+Bi)
        re = P1 - P2, im = P3 - P1 - P2
    `mm(x, y)` is the engine's policy-carrying real matmul (precision /
    Ozaki routing decided there). One fewer GEMM than the textbook 4-GEMM
    form; the extra additions are memory-cheap."""
    p1 = mm(ar, br)
    p2 = mm(ai, bi)
    p3 = mm(ar + ai, br + bi)
    return p1 - p2, p3 - p1 - p2
