"""Split-plane FFT: double-precision FFT on (re, im) plane pairs.

Why this exists: MATLAB's default class is double, so `fft` must deliver
~1e-12 parity. In split-plane complex mode (RUNMAT_TPU_COMPLEX_NATIVE=0,
see accel/cplx.py) no complex128 dtype may appear, so XLA's native FFT is
unusable for doubles there. This module implements the FFT in pure REAL f64
arithmetic on split planes:

  * power-of-two n: radix-2 Stockham (autosorting — no bit-reversal
    gather, just reshape/stack layout changes, which XLA turns into cheap
    copies). log2(n) passes, each a fused elementwise stage.
  * arbitrary n: Bluestein chirp-z over the power-of-two core
    (3 Stockham FFTs of size m = next_pow2(2n-1)).

Twiddles and chirps are host-precomputed f64 numpy constants baked into
the jit trace — exact to the last ulp, no device trig involved.

Reference parity: the staged radix FFT dispatch in the wgpu backend
(runmat-accelerate/src/backend/wgpu/provider/ops/fft/kernels.rs,
dispatch/fft.rs) — same role, split-plane formulation.

For `single` inputs the engine uses XLA's native FFT with an *internal*
complex64 (allowed — only boundary complex fails); this module is the f64
path. All functions take/return plane PAIRS on the LAST axis; the engine
moves the target axis last.
"""

from __future__ import annotations

import numpy as np


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _stockham(jnp, xr, xi, sign: float):
    """Radix-2 Stockham FFT over the last axis (length must be a power of
    two). Autosorting: each stage appends the new output-index digit as the
    most significant of the group axis, so no bit-reversal pass is needed."""
    n = xr.shape[-1]
    if n <= 1:
        return xr, xi
    batch = xr.shape[:-1]
    nb = len(batch)
    L, N = 1, n
    ar = xr.reshape(batch + (1, n))
    ai = xi.reshape(batch + (1, n))
    while N > 1:
        half = N // 2
        ur, ui = ar[..., :, :half], ai[..., :, :half]
        vr, vi = ar[..., :, half:], ai[..., :, half:]
        ang = sign * 2.0 * np.pi * np.arange(half, dtype=np.float64) / N
        wr, wi = np.cos(ang), np.sin(ang)
        er, ei = ur + vr, ui + vi
        dr, di = ur - vr, ui - vi
        o_r = dr * wr - di * wi
        o_i = dr * wi + di * wr
        ar = jnp.stack([er, o_r], axis=nb).reshape(batch + (L * 2, half))
        ai = jnp.stack([ei, o_i], axis=nb).reshape(batch + (L * 2, half))
        L, N = L * 2, half
    return ar.reshape(batch + (n,)), ai.reshape(batch + (n,))


def _bluestein(jnp, xr, xi, sign: float):
    """Chirp-z FFT for arbitrary n: X = chirp * IFFT(FFT(x*chirp) * FFT(b))
    with b the circularly-extended conjugate chirp, over a pow2 core."""
    n = xr.shape[-1]
    m = _next_pow2(2 * n - 1)
    j = np.arange(n, dtype=np.float64)
    ang = sign * np.pi * (j * j % (2.0 * n)) / n      # exact mod keeps phase
    cr, ci = np.cos(ang), np.sin(ang)                  # chirp c_j
    # a = x * c, zero-padded to m
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - n)]
    a_r = jnp.pad(xr * cr - xi * ci, pad)
    a_i = jnp.pad(xr * ci + xi * cr, pad)
    # b_j = conj(c_|j|) circularly: b[0:n] = conj(c), b[m-n+1:m] mirrors
    b_r = np.zeros(m)
    b_i = np.zeros(m)
    b_r[:n], b_i[:n] = cr, -ci
    b_r[m - n + 1:], b_i[m - n + 1:] = cr[1:][::-1], -ci[1:][::-1]
    # host-precomputed FFT(b) — exact constants, zero device work
    B = np.fft.fft(b_r + 1j * b_i)
    Br, Bi = B.real, B.imag
    fr, fi = _stockham(jnp, a_r, a_i, -1.0)
    gr = fr * Br - fi * Bi
    gi = fr * Bi + fi * Br
    # inverse pow2 FFT via conjugation
    hr, hi = _stockham(jnp, gr, -gi, -1.0)
    hr, hi = hr / m, -hi / m
    hr, hi = hr[..., :n], hi[..., :n]
    return hr * cr - hi * ci, hr * ci + hi * cr


def fft_planes(jnp, xr, xi, inverse: bool = False):
    """FFT (or inverse) along the LAST axis of a split-plane pair. Any
    length; MATLAB scaling (ifft divides by n)."""
    n = xr.shape[-1]
    if n == 0:
        return xr, xi
    if inverse:
        yr, yi = fft_planes(jnp, xr, -xi, inverse=False)
        return yr / n, -yi / n
    if n & (n - 1) == 0:
        return _stockham(jnp, xr, xi, -1.0)
    return _bluestein(jnp, xr, xi, -1.0)


def fft_planes_axis(jnp, xr, xi, axis: int, inverse: bool = False):
    """FFT along `axis` (planes move it last, transform, move back)."""
    nd = xr.ndim
    axis = axis % nd
    if axis != nd - 1:
        xr = jnp.moveaxis(xr, axis, -1)
        xi = jnp.moveaxis(xi, axis, -1)
    yr, yi = fft_planes(jnp, xr, xi, inverse=inverse)
    if axis != nd - 1:
        yr = jnp.moveaxis(yr, -1, axis)
        yi = jnp.moveaxis(yi, -1, axis)
    return yr, yi
