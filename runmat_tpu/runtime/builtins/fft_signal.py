"""FFT & signal builtins: fft/ifft/fft2/ifft2/fftshift/filter/conv2.

Reference parity: runmat-runtime/src/builtins/math/{fft,signal} + provider
fft_dim/ifft_dim/conv2/iir_filter hooks (runmat-accelerate-api/src/lib.rs:
2535-2577). Host numpy path; device arrays route through the engine's fft ops.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, is_text, text_of
from ..registry import builtin
from .common import scalar_int


def _cx(x: MatArray) -> np.ndarray:
    h = x.host()
    return h.astype(np.complex128 if h.dtype.kind != "c" else h.dtype)


def _default_dim(h: np.ndarray) -> int:
    return _default_dim_shape(h.shape)


def _default_dim_shape(shape) -> int:
    for i, s in enumerate(shape):
        if s != 1:
            return i
    return 0


def _fft_impl(x, n, dim, inverse: bool):
    if isinstance(x, MatArray):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_fft(x):
            ax = (scalar_int(dim) - 1) if dim is not None else \
                _default_dim_shape(x.shape)
            nn = scalar_int(n) if n is not None and n.size else None
            r = eng.fft(x, nn, ax, inverse)
            if r is not None:
                return r
    h = _cx(x)
    ax = (scalar_int(dim) - 1) if dim is not None else _default_dim(h)
    nn = scalar_int(n) if n is not None and n.size else None
    fn = np.fft.ifft if inverse else np.fft.fft
    r = fn(h, n=nn, axis=ax)
    out_class = "single" if x.mclass == "single" else "double"
    if inverse and not x.is_complex:
        if np.allclose(r.imag, 0, atol=1e-12):
            r = r.real
    if out_class == "single":
        r = r.astype(np.complex64 if np.iscomplexobj(r) else np.float32)
    return MatArray(r, out_class)


@builtin("fft", category="math/fft", min_in=1, max_in=3)
def m_fft(x, n=None, dim=None):
    return _fft_impl(x, n, dim, inverse=False)


@builtin("ifft", category="math/fft", min_in=1, max_in=3)
def m_ifft(x, n=None, dim=None):
    return _fft_impl(x, n, dim, inverse=True)


def _fft2_impl(x, m, n, inverse: bool):
    if m is None and n is None and isinstance(x, MatArray) and \
            len(x.shape) == 2:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            out = eng.linalg("fft2", [x], (bool(inverse),),
                             out_class="single" if x.mclass == "single"
                             else "double")
            if out is not None:
                return out[0]
        if eng is not None and not eng.supports_complex and eng.route_fft(x):
            # split-plane platforms: fft2 = fftL along each axis in turn
            r = eng.fft(x, None, 0, inverse)
            if r is not None:
                r2 = eng.fft(r, None, 1, inverse)
                if r2 is not None:
                    return r2
    h = _cx(x)
    s = (scalar_int(m), scalar_int(n)) if m is not None and n is not None else None
    r = (np.fft.ifft2 if inverse else np.fft.fft2)(h, s=s)
    return MatArray(r, "single" if x.mclass == "single" else "double")


@builtin("fft2", category="math/fft", min_in=1, max_in=3)
def m_fft2(x, m=None, n=None):
    return _fft2_impl(x, m, n, inverse=False)


@builtin("ifft2", category="math/fft", min_in=1, max_in=3)
def m_ifft2(x, m=None, n=None):
    return _fft2_impl(x, m, n, inverse=True)


@builtin("fftshift", category="math/fft", min_in=1, max_in=2)
def m_fftshift(x, dim=None):
    h = x.host()
    ax = scalar_int(dim) - 1 if dim is not None else None
    return MatArray(np.fft.fftshift(h, axes=ax), x.mclass)


@builtin("ifftshift", category="math/fft", min_in=1, max_in=2)
def m_ifftshift(x, dim=None):
    h = x.host()
    ax = scalar_int(dim) - 1 if dim is not None else None
    return MatArray(np.fft.ifftshift(h, axes=ax), x.mclass)


@builtin("filter", category="math/signal", min_in=3, max_in=4)
def m_filter(b, a, x, zi=None):
    """Direct-form-II-transposed filter (≙ provider iir_filter hook,
    api lib.rs:2535-2577). Device path: FIR (a scalar) is a causal
    conv_general_dilated; IIR runs as one lax.scan kernel. Host path:
    scipy lfilter."""
    bb = b.host().astype(np.float64).reshape(-1)
    aa = a.host().astype(np.float64).reshape(-1)
    if aa[0] == 0:
        raise bad_arg("filter", "First denominator coefficient must be nonzero.")
    bb = bb / aa[0]
    aa = aa / aa[0]
    out_class = "single" if x.mclass == "single" else "double"
    is_col_dev = isinstance(x, MatArray) and x.shape[1] == 1 and \
        x.shape[0] > 1
    if isinstance(x, MatArray) and not x.is_complex and zi is None:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            if aa.size == 1:
                out = eng.linalg("fir", [x, MatArray(bb.reshape(1, -1),
                                                     "double")])
            else:
                n = max(len(aa), len(bb))
                bp = np.pad(bb, (0, n - len(bb)))
                ap = np.pad(aa, (0, n - len(aa)))
                out = eng.linalg("iir", [
                    x, MatArray(bp.reshape(1, -1), "double"),
                    MatArray(ap.reshape(1, -1), "double"),
                    MatArray(np.zeros((1, n - 1)), "double")])
            if out is not None:
                r = out[0]
                if not is_col_dev and r.shape[0] > 1:
                    r = eng.reshape(r, (1, r.size))
                return r
    h = x.host().astype(np.float64)
    is_col = h.ndim == 2 and h.shape[1] == 1
    v = h.reshape(-1)
    n = max(len(aa), len(bb))
    bb = np.pad(bb, (0, n - len(bb)))
    aa = np.pad(aa, (0, n - len(aa)))
    from scipy.signal import lfilter
    if zi is not None:
        z = np.zeros(n - 1)
        z0 = zi.host().astype(np.float64).reshape(-1)
        z[:len(z0)] = z0
        y, _ = lfilter(bb, aa, v, zi=z)
    else:
        y = lfilter(bb, aa, v)
    out = y.reshape(-1, 1) if is_col else y.reshape(1, -1)
    return MatArray(out, out_class)


@builtin("conv2", category="math/signal", min_in=2, max_in=3)
def m_conv2(a, b, shape=None):
    mode = text_of(shape) if shape is not None else "full"
    if isinstance(a, MatArray) and isinstance(b, MatArray) and \
            not a.is_complex and not b.is_complex and \
            mode in ("full", "same", "valid") and \
            len(a.shape) == 2 and len(b.shape) == 2 and \
            (mode != "valid" or (a.shape[0] >= b.shape[0]
                                 and a.shape[1] >= b.shape[1])):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(a, b):
            # ≙ provider conv2d: one conv_general_dilated on device
            out = eng.linalg("conv2", [a, b], (mode,))
            if out is not None:
                return out[0]
    ha = a.host().astype(np.float64)
    hb = b.host().astype(np.float64)
    # direct 2-D convolution via FFT for large kernels, sliding otherwise
    out_full_shape = (ha.shape[0] + hb.shape[0] - 1, ha.shape[1] + hb.shape[1] - 1)
    r = np.fft.irfft2(np.fft.rfft2(ha, out_full_shape) * np.fft.rfft2(hb, out_full_shape),
                      out_full_shape)
    if mode == "same":
        r0 = (hb.shape[0] - 1) // 2
        c0 = (hb.shape[1] - 1) // 2
        r = r[r0:r0 + ha.shape[0], c0:c0 + ha.shape[1]]
    elif mode == "valid":
        r = r[hb.shape[0] - 1:ha.shape[0], hb.shape[1] - 1:ha.shape[1]]
    out_class = "single" if a.mclass == "single" else "double"
    from ... import dtypes
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)


def xcorr_impl(va: np.ndarray, vb, maxlag, scale: str) -> np.ndarray:
    """Shared xcorr/xcov core: full cross-correlation r_xy(k) =
    sum x(n+k) conj(y(n)), sliced to -maxlag..maxlag, MATLAB scaleopt
    ('none'|'biased'|'unbiased'|'normalized'/'coeff')."""
    auto = vb is None
    vb = va if vb is None else vb
    n = max(va.size, vb.size)
    if va.size < n:
        va = np.concatenate([va, np.zeros(n - va.size)])
    if vb.size < n:
        vb = np.concatenate([vb, np.zeros(n - vb.size)])
    r = np.correlate(va, vb, mode="full")      # lags -(n-1)..(n-1)
    ml = int(maxlag) if maxlag is not None else n - 1
    if ml < 0:
        raise bad_arg("maxlag", "maxlag must be nonnegative.")
    lags = np.arange(-ml, ml + 1)
    if ml <= n - 1:
        r = r[(n - 1) - ml:(n - 1) + ml + 1]
    else:                                      # zero-pad beyond data lags
        pad = ml - (n - 1)
        r = np.concatenate([np.zeros(pad), r, np.zeros(pad)])
    if scale == "biased":
        r = r / n
    elif scale == "unbiased":
        r = r / np.maximum(n - np.abs(lags), 1)
    elif scale in ("normalized", "coeff"):
        if auto:
            d = np.dot(va, va)
        else:
            d = np.sqrt(np.dot(va, va) * np.dot(vb, vb))
        r = r / d if d > 0 else r
    elif scale != "none":
        raise bad_arg("scaleopt", f"Unknown option '{scale}'.")
    return r


def _xcorr_args(rest):
    """Trailing (maxlag?, scaleopt?) parse shared by xcorr/xcov: a scalar
    numeric is maxlag, text is the scale option (MATLAB order-insensitive
    here since the types disambiguate)."""
    maxlag, scale, sig = None, "none", None
    for a in rest:
        if a is None:
            continue
        if is_text(a):
            scale = text_of(a).lower()
        elif isinstance(a, MatArray) and a.size == 1:
            maxlag = int(a.host().reshape(-1)[0])
        elif isinstance(a, MatArray):
            sig = a
    return sig, maxlag, scale


@builtin("xcorr", category="math/signal", min_in=1, max_in=4,
         pass_nargout=True)
def m_xcorr(a, *rest, nargout=1):
    """Cross-/auto-correlation with MATLAB's full surface:
    xcorr(x), xcorr(x,y), xcorr(__,maxlag), xcorr(__,scaleopt);
    [r,lags] = xcorr(__). A scalar trailing numeric is maxlag, never a
    second signal (ADVICE r4 #1)."""
    sig, maxlag, scale = _xcorr_args(rest)
    va = a.host().astype(np.float64).reshape(-1)
    vb = sig.host().astype(np.float64).reshape(-1) if sig is not None \
        else None
    r = xcorr_impl(va, vb, maxlag, scale)
    ml = (r.size - 1) // 2
    outs = [MatArray(r.reshape(1, -1), "double"),
            MatArray(np.arange(-ml, ml + 1, dtype=np.float64).reshape(1, -1),
                     "double")]
    return outs[:max(1, nargout)]


# --------------------------------------------------------------------------- #
# windows + spectral analysis
# (≙ reference math/signal family; provider hooks api lib.rs:2535-2577)
# --------------------------------------------------------------------------- #


def _window_vec(n: int, kind: str) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    if kind in ("hann", "hanning"):
        return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    if kind == "blackman":
        return 0.42 - 0.5 * np.cos(2 * np.pi * k / (n - 1)) \
            + 0.08 * np.cos(4 * np.pi * k / (n - 1))
    if kind == "bartlett":
        return 1.0 - np.abs((k - (n - 1) / 2) / ((n - 1) / 2))
    if kind == "rectwin":
        return np.ones(n)
    raise bad_arg("window", f"Unknown window '{kind}'.")


def _win_builtin(name):
    @builtin(name, category="math/signal", min_in=1, max_in=1)
    def _f(n, _name=name):
        nn = int(n.host().reshape(-1)[0])
        return MatArray(_window_vec(nn, _name).reshape(-1, 1), "double")
    return _f


for _w in ("hamming", "hann", "hanning", "blackman", "bartlett", "rectwin"):
    _win_builtin(_w)


@builtin("kaiser", category="math/signal", min_in=1, max_in=2)
def m_kaiser(n, beta=None):
    nn = int(n.host().reshape(-1)[0])
    b = float(beta.host().reshape(-1)[0]) if beta is not None else 0.5
    k = np.arange(nn, dtype=np.float64)
    r = 2 * k / max(nn - 1, 1) - 1
    w = np.i0(b * np.sqrt(np.maximum(1 - r * r, 0))) / np.i0(b)
    return MatArray(w.reshape(-1, 1), "double")


@builtin("sinc", category="math/signal", min_in=1, max_in=1, accel_op="u:sinc")
def m_sinc(x):
    h = x.host().astype(np.float64)
    return MatArray(np.sinc(h), "single" if x.mclass == "single" else "double")


@builtin("hilbert", category="math/signal", min_in=1, max_in=2)
def m_hilbert(x, n=None):
    """Analytic signal via the one-sided FFT method (device path: one
    fused fft/weight/ifft kernel — ≙ provider hilbert hook)."""
    npts_req = int(n.host().reshape(-1)[0]) if n is not None else x.size
    if isinstance(x, MatArray) and not x.is_complex and \
            npts_req == x.size:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            out = eng.linalg("hilbert", [x], (npts_req, False))
            if out is not None:
                r = out[0]
                if x.shape[0] == 1 and r.shape[0] > 1:
                    r = eng.reshape(r, (1, r.size))
                return r
    h = x.host().astype(np.float64)
    vec = h.reshape(-1)
    npts = int(n.host().reshape(-1)[0]) if n is not None else vec.size
    sp = np.fft.fft(vec, npts)
    w = np.zeros(npts)
    if npts % 2 == 0:
        w[0] = w[npts // 2] = 1
        w[1:npts // 2] = 2
    else:
        w[0] = 1
        w[1:(npts + 1) // 2] = 2
    r = np.fft.ifft(sp * w)
    shape = (1, npts) if h.shape[0] == 1 else (npts, 1)
    return MatArray(r.reshape(shape), "double")


@builtin("envelope", category="math/signal", min_in=1, max_in=1)
def m_envelope(x):
    if isinstance(x, MatArray) and not x.is_complex:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            out = eng.linalg("hilbert", [x], (int(x.size), True))
            if out is not None:
                r = out[0]
                if tuple(r.shape) != tuple(x.shape):
                    r = eng.reshape(r, tuple(x.shape))
                return r
    h = x.host().astype(np.float64).reshape(-1)
    sp = np.fft.fft(h)
    w = np.zeros(h.size)
    if h.size % 2 == 0:
        w[0] = w[h.size // 2] = 1
        w[1:h.size // 2] = 2
    else:
        w[0] = 1
        w[1:(h.size + 1) // 2] = 2
    analytic = np.fft.ifft(sp * w)
    env = np.abs(analytic)
    shape = x.host().shape
    return MatArray(env.reshape(shape), "double")


@builtin("spectrogram", category="math/signal", min_in=1, max_in=4, max_out=4,
         pass_nargout=True)
def m_spectrogram(x, window=None, noverlap=None, nfft=None, nargout=1):
    n_in = int(x.size)     # sizes from metadata: no gather on the device path
    if window is None:
        nseg = max(8, n_in // 8)
        w = _window_vec(nseg, "hamming")
    elif window.size == 1:
        nseg = int(window.host().reshape(-1)[0])
        w = _window_vec(nseg, "hamming")
    else:
        w = window.host().astype(np.float64).reshape(-1)
        nseg = w.size
    nov = int(noverlap.host().reshape(-1)[0]) if noverlap is not None else nseg // 2
    nf = int(nfft.host().reshape(-1)[0]) if nfft is not None else max(256, nseg)
    hop = nseg - nov
    nwin = max(0, (n_in - nov) // hop)
    nbins = nf // 2 + 1
    S = None
    if isinstance(x, MatArray) and not x.is_complex and nwin > 0:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            # whole STFT as one device kernel (frame gather + window +
            # batched FFT); gather to host for the return shape/F/T math
            out = eng.dense.call(
                "spectrogram",
                [x, MatArray(w.reshape(1, -1), "double")],
                (nseg, hop, nf, nwin, nbins))
            if out is not None:
                S = np.asarray(out[0])
    if S is None:
        h = x.host().astype(np.float64).reshape(-1)
        S = np.empty((nbins, nwin), dtype=complex)
        for i in range(nwin):
            seg = h[i * hop: i * hop + nseg] * w
            S[:, i] = np.fft.fft(seg, nf)[:nbins]
    if nargout <= 1:
        return MatArray(S, "double")
    F = np.arange(nbins, dtype=np.float64).reshape(-1, 1) / nf
    T = ((np.arange(nwin) * hop + nseg / 2)).reshape(1, -1)
    return [MatArray(S, "double"), MatArray(F, "double"),
            MatArray(T.astype(np.float64), "double")][:max(1, nargout)]


@builtin("freqz", category="math/signal", min_in=1, max_in=3, max_out=2,
         pass_nargout=True)
def m_freqz(b, a=None, n=None, nargout=1):
    hb = b.host().astype(np.float64).reshape(-1)
    ha = a.host().astype(np.float64).reshape(-1) if a is not None else np.ones(1)
    npts = int(n.host().reshape(-1)[0]) if n is not None else 512
    w = np.pi * np.arange(npts) / npts
    z = np.exp(-1j * w)
    num = sum(hb[k] * z ** k for k in range(hb.size))
    den = sum(ha[k] * z ** k for k in range(ha.size))
    H = num / den
    if nargout <= 1:
        return MatArray(H.reshape(-1, 1), "double")
    return [MatArray(H.reshape(-1, 1), "double"),
            MatArray(w.reshape(-1, 1), "double")]


@builtin("pwelch", category="math/signal", min_in=1, max_in=4, max_out=2,
         pass_nargout=True)
def m_pwelch(x, window=None, noverlap=None, nfft=None, nargout=1):
    h = x.host().astype(np.float64).reshape(-1)
    nseg = int(window.host().reshape(-1)[0]) if window is not None and \
        window.size == 1 else min(256, h.size)
    w = window.host().astype(np.float64).reshape(-1) if window is not None and \
        window.size > 1 else _window_vec(nseg, "hamming")
    nseg = w.size
    nov = int(noverlap.host().reshape(-1)[0]) if noverlap is not None else nseg // 2
    nf = int(nfft.host().reshape(-1)[0]) if nfft is not None else max(256, nseg)
    hop = nseg - nov
    nwin = max(1, (h.size - nov) // hop)
    nbins = nf // 2 + 1
    U = np.sum(w ** 2)
    acc = None
    if isinstance(x, MatArray) and not x.is_complex and \
            (h.size - nov) // hop >= 1:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            # Welch periodograms ride the one-kernel device STFT
            out = eng.dense.call(
                "spectrogram", [x, MatArray(w.reshape(1, -1), "double")],
                (nseg, hop, nf, nwin, nbins))
            if out is not None:
                S = np.asarray(out[0])
                acc = (np.abs(S) ** 2 / U).sum(axis=1)
    if acc is None:
        acc = np.zeros(nbins)
        for i in range(nwin):
            seg = h[i * hop: i * hop + nseg]
            if seg.size < nseg:
                seg = np.pad(seg, (0, nseg - seg.size))
            sp = np.fft.fft(seg * w, nf)[:nbins]
            acc += (np.abs(sp) ** 2) / U
    pxx = acc / nwin / (2 * np.pi)
    pxx[1:-1] *= 2
    if nargout <= 1:
        return MatArray(pxx.reshape(-1, 1), "double")
    w_out = np.pi * np.arange(nbins) / (nbins - 1)
    return [MatArray(pxx.reshape(-1, 1), "double"),
            MatArray(w_out.reshape(-1, 1), "double")]


@builtin("detrend", category="math/signal", min_in=1, max_in=2)
def m_detrend(x, mode=None):
    h = x.host().astype(np.float64)
    m = text_of(mode) if mode is not None and is_text(mode) else "linear"
    vec = h.reshape(-1)
    if m == "constant":
        r = vec - vec.mean()
    else:
        t = np.arange(vec.size, dtype=np.float64)
        p = np.polyfit(t, vec, 1)
        r = vec - np.polyval(p, t)
    return MatArray(r.reshape(h.shape), "double")
