"""Compensated double-precision GEMM from int8 products (Ozaki-scheme).

MATLAB's default class is `double`. This module implements the opt-in
`ozaki` matmul-precision policy for devices whose f64 GEMM is slow or
emulated: each f64 operand is
split into per-row (resp. per-column) power-of-two scales and 6 signed
7-bit integer digit slices, the 21 digit-pair products with combined weight
>= 2^-49 are computed as int8 x int8 -> int32 GEMMs (EXACT: |digit| <=
64, so |sum| <= K * 2^12 never overflows int32 for K <= 65536), and the
diagonal sums are recombined in f64. The only approximation is the digit
truncation at 2^-42 relative to the row/column scale — ~1e-12 relative on
the CPU backend (tests/test_precision_policy), where the int32 products are
exact. On the H100 the scheme is both slower than native f64 GEMM and only
~3e-8 accurate (the int8 products lose exactness somewhere in XLA's GPU
lowering; cause not isolated, PERF.md); the default policy never routes
here.

An analog of the reference's precision guard
(runmat-accelerate/src/precision.rs:40-60): rather than rejecting f64 on a
reduced-precision device, the policy buys back f64 accuracy from exact
integer arithmetic. Scheme after Ozaki et al. (error-free matmul
transformations).

Digit extraction runs almost entirely in f32: the row-scaled
value r (|r| <= 1/2, scaling by a power of two is exact) is represented as
an (hi, mid) f32 pair; the first 4 digits come exactly out of `hi`
(power-of-two multiplies, round, and small-value subtractions are all exact
in f32), then `mid` is folded in for digits 5-6. Only the initial scale and
the final recombination touch f64 elementwise ops.
"""

from __future__ import annotations

DIGITS = 6          # 7-bit signed digit slices per operand
DIGIT_BITS = 7
MAX_K = 65536       # int32 exactness guard: 6 * K * 72^2 < 2^31


def supported(a_shape, b_shape, dtype_kind: str) -> bool:
    """Whether the ozaki path applies: real f64, inner dim within the
    int32-exactness bound."""
    return dtype_kind == "f" and len(a_shape) == 2 and \
        a_shape[1] <= MAX_K


def _digits_along(jnp, x, axis: int):
    """Split f64 `x` into (scale, [int8 digit slices]) along `axis`
    (axis=1: per-row scales for the left operand; axis=0: per-column for
    the right). scale * sum_i digits[i] * 2^-7(i+1) == x to 2^-42*scale."""
    import numpy as np
    xmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    # power-of-two scale with |r| <= 1/2. frexp would be the natural tool
    # but its s64 bitcast does not survive every backend's x64 rewrite; log2+ceil
    # with a one-step fixup is exact regardless of libm rounding.
    xm = jnp.where(xmax > 0, xmax, 1.0)
    e = jnp.ceil(jnp.log2(xm)) + 1.0
    e = e + (xm * jnp.exp2(-e) > 0.5)
    scale = jnp.exp2(e)
    r = x * jnp.exp2(-e)                      # exact: power-of-two multiply
    hi = r.astype(jnp.float32)
    mid = (r - hi.astype(jnp.float64)).astype(jnp.float32)
    digs = []
    t = hi
    for i in range(DIGITS):
        if i == 3:
            # hi = f32(r) only approximates r to half an f32 ulp (2^-25),
            # so digits below bit 21 must see the second component. Fold
            # it in before digit 4 (grid floor 2^-28 < 2^-25): the fold
            # digit can reach |d| <= 72 (still int8- and int32-exact; see
            # MAX_K), and the f32 add rounds at ~2^-46 absolute — far
            # below the 2^-42 truncation floor.
            t = t + mid
        up = np.float32(2.0 ** (DIGIT_BITS * (i + 1)))
        d = jnp.round(t * up)                 # |d| <= 72, exact in f32
        digs.append(d.astype(jnp.int8))
        t = t - d * np.float32(2.0 ** (-DIGIT_BITS * (i + 1)))
    return scale, digs


def gemm_f64(jnp, a, b):
    """C = a @ b for real float64 via 21 exact int8 products.

    Keeps digit pairs with i + j <= DIGITS - 1 (combined weight >= 2^-49);
    same-diagonal products are summed in int32 (exact, see module doc)
    before the 6 weighted f64 accumulations.

    Non-finite entries cannot ride the digit representation; affected
    output rows/columns are NaN (documented policy limitation — the native
    f64 path keeps full Inf/NaN semantics).
    """
    from jax import lax
    bad_a = ~jnp.all(jnp.isfinite(a), axis=1, keepdims=True)    # (M,1)
    bad_b = ~jnp.all(jnp.isfinite(b), axis=0, keepdims=True)    # (1,N)
    a = jnp.where(jnp.isfinite(a), a, 0.0)
    b = jnp.where(jnp.isfinite(b), b, 0.0)
    sa, da = _digits_along(jnp, a, axis=1)         # (M,1), int8 (M,K)
    sb, db = _digits_along(jnp, b, axis=0)         # (1,N), int8 (K,N)
    diag = [None] * DIGITS
    for i in range(DIGITS):
        for j in range(DIGITS - i):
            p = lax.dot(da[i], db[j], preferred_element_type=jnp.int32)
            d = i + j
            diag[d] = p if diag[d] is None else diag[d] + p
    acc = None
    for d in range(DIGITS):
        w = 2.0 ** (-DIGIT_BITS * (d + 2))
        term = diag[d].astype(jnp.float64) * w
        acc = term if acc is None else acc + term
    out = sa * acc * sb
    return jnp.where(bad_a | bad_b, jnp.nan, out)
