"""Split-plane complex device path (accel/cplx.py) — VERDICT r4 #2.

Forces RUNMAT_TPU_COMPLEX_NATIVE=0 so the CPU engine takes the split-plane
representation (complex values as stacked re/im real planes, no complex
dtype at any program boundary), and pins the full complex surface against
host numpy. The native-complex CPU path is covered
by the rest of the suite; this file isolates the planes mode.

Reference parity: complex elementwise on GPU via interleaved storage
(runmat-accelerate-api/src/lib.rs:247-251,
runmat-accelerate/src/backend/wgpu/shaders/elementwise.rs).
"""

import subprocess

import numpy as np
import pytest


@pytest.fixture(scope="module")
def sess():
    import os
    from runmat_tpu.session import Session
    os.environ["RUNMAT_TPU_COMPLEX_NATIVE"] = "0"
    _reset_probe()
    try:
        s = Session(accelerate=True)
        eng = _engine()
        assert eng is not None and not eng.supports_complex
        yield s
    finally:
        os.environ.pop("RUNMAT_TPU_COMPLEX_NATIVE", None)
        _reset_probe()


def _engine():
    from runmat_tpu.accel import active_engine
    return active_engine()


def _reset_probe():
    eng = _engine()
    if eng is not None:
        eng._supports_complex = None


def run_get(sess, src, names):
    r = sess.execute(src)
    assert r.error is None, r.error
    out = []
    for n in names:
        v = sess.get(n)
        out.append(np.asarray(v.host()))
    return out


Z = np.array([1 + 2j, 3 - 4j])


def test_upload_gather_roundtrip(sess):
    (g,) = run_get(sess, "zz = gather(gpuArray([1+2i, 3-4i]));", ["zz"])
    assert np.array_equal(g.reshape(-1), Z)


def test_elementwise_surface(sess):
    src = """
z = gpuArray([1+2i, 3-4i]);
ab = gather(abs(z)); cj = gather(conj(z));
re = gather(real(z)); im = gather(imag(z));
an = gather(angle(z)); sq = gather(sqrt(z));
ex = gather(exp(z)); lg = gather(log(z));
sg = gather(sign(z)); ng = gather(-z);
sn = gather(sin(z)); tn = gather(tanh(z));
"""
    names = "ab cj re im an sq ex lg sg ng sn tn".split()
    vals = run_get(sess, src, names)
    want = [np.abs(Z), np.conj(Z), Z.real, Z.imag, np.angle(Z), np.sqrt(Z),
            np.exp(Z), np.log(Z), Z / np.abs(Z), -Z, np.sin(Z), np.tanh(Z)]
    for n, got, w in zip(names, vals, want):
        assert np.max(np.abs(got.reshape(-1) - w)) < 1e-12, n


def test_binary_arith_and_compare(sess):
    src = """
z = gpuArray([1+2i, 3-4i]);
w = gpuArray([2-1i, -1+1i]);
s = gather(z + w); d = gather(z - w);
m = gather(z .* w); q = gather(z ./ w);
p = gather(z .^ 2); pc = gather(z .^ (1+1i));
mixed = gather(z * 2 + 1);
eqv = gather(z == z); nev = gather(z ~= w);
ltv = gather(z < w);
"""
    names = "s d m q p pc mixed eqv nev ltv".split()
    vals = run_get(sess, src, names)
    W = np.array([2 - 1j, -1 + 1j])
    want = [Z + W, Z - W, Z * W, Z / W, Z ** 2, Z ** (1 + 1j),
            Z * 2 + 1, np.ones(2), np.ones(2),
            (Z.real < W.real).astype(float)]
    for n, got, w in zip(names, vals, want):
        assert np.max(np.abs(got.reshape(-1).astype(complex) - w)) < 1e-12, n


def test_matmul_karatsuba(sess):
    src = """
rng(5);
Ar = rand(32); Ai = rand(32); Br = rand(32); Bi = rand(32);
A = gpuArray(Ar + 1i*Ai); B = gpuArray(Br + 1i*Bi);
C = gather(A * B);
"""
    (C,) = run_get(sess, src, ["C"])
    Ar = np.asarray(sess.get("Ar").host())
    Ai = np.asarray(sess.get("Ai").host())
    Br = np.asarray(sess.get("Br").host())
    Bi = np.asarray(sess.get("Bi").host())
    ref = (Ar + 1j * Ai) @ (Br + 1j * Bi)
    assert np.max(np.abs(C - ref)) / np.max(np.abs(ref)) < 1e-12


def test_reductions_scans(sess):
    src = """
z = gpuArray([1+2i, 3-4i, -2+1i]);
s = gather(sum(z)); m = gather(mean(z)); c = gather(cumsum(z));
"""
    s, m, c = run_get(sess, src, ["s", "m", "c"])
    Z3 = np.array([1 + 2j, 3 - 4j, -2 + 1j])
    assert abs(s.reshape(-1)[0] - Z3.sum()) < 1e-12
    assert abs(m.reshape(-1)[0] - Z3.mean()) < 1e-12
    assert np.max(np.abs(c.reshape(-1) - np.cumsum(Z3))) < 1e-12


def test_indexing_and_writes(sess):
    src = """
z = gpuArray([1+2i, 3-4i, 5+6i, 7-8i]);
a = gather(z(2:3));
z(1) = 9 + 9i;
b = gather(z);
M = gpuArray([1+1i 2+2i; 3+3i 4+4i]);
col = gather(M(:, 2));
M(2, 1) = 0;
c = gather(M);
fl = gather(flipud(gpuArray([1+1i; 2+2i])));
tp = gather(gpuArray([1+1i; 2-3i])');
rs = gather(reshape(gpuArray([1+1i 2+2i 3+3i 4+4i]), 2, 2));
"""
    a, b, col, c, fl, tp, rs = run_get(
        sess, src, ["a", "b", "col", "c", "fl", "tp", "rs"])
    assert np.array_equal(a.reshape(-1), [3 - 4j, 5 + 6j])
    assert np.array_equal(b.reshape(-1), [9 + 9j, 3 - 4j, 5 + 6j, 7 - 8j])
    assert np.array_equal(col.reshape(-1), [2 + 2j, 4 + 4j])
    assert np.array_equal(c, [[1 + 1j, 2 + 2j], [0, 4 + 4j]])
    assert np.array_equal(fl.reshape(-1), [2 + 2j, 1 + 1j])
    assert np.array_equal(tp.reshape(-1), [1 - 1j, 2 + 3j])
    assert np.array_equal(rs, [[1 + 1j, 3 + 3j], [2 + 2j, 4 + 4j]])


@pytest.mark.parametrize("n", [8, 100, 127, 1024])
def test_fft_double_parity(sess, n):
    src = f"""
rng(7);
xr = rand(1, {n}) - 0.5; xi = rand(1, {n}) - 0.5;
f = gather(fft(gpuArray(xr + 1i*xi)));
fr = gather(fft(gpuArray(xr)));
rt = gather(ifft(fft(gpuArray(xr + 1i*xi))));
"""
    f, fr, rt = run_get(sess, src, ["f", "fr", "rt"])
    xr = np.asarray(sess.get("xr").host()).reshape(-1)
    xi = np.asarray(sess.get("xi").host()).reshape(-1)
    z = xr + 1j * xi
    scale = max(np.max(np.abs(np.fft.fft(z))), 1.0)
    assert np.max(np.abs(f.reshape(-1) - np.fft.fft(z))) / scale < 1e-12
    assert np.max(np.abs(fr.reshape(-1) - np.fft.fft(xr))) / scale < 1e-12
    assert np.max(np.abs(rt.reshape(-1) - z)) < 1e-12


def test_fft2_planes(sess):
    src = """
rng(9);
X = rand(8, 6) + 1i*rand(8, 6);
F = gather(fft2(gpuArray(X)));
"""
    (F,) = run_get(sess, src, ["F"])
    X = np.asarray(sess.get("X").host())
    assert np.max(np.abs(F - np.fft.fft2(X))) / np.max(
        np.abs(np.fft.fft2(X))) < 1e-12


def test_fft_single_uses_internal_c64(sess):
    src = """
x = single([1 2 3 4 5 6 7 8]);
f = gather(fft(gpuArray(x)));
"""
    (f,) = run_get(sess, src, ["f"])
    ref = np.fft.fft(np.arange(1, 9, dtype=np.float64))
    assert np.max(np.abs(f.reshape(-1) - ref)) < 1e-3


def test_unsupported_complex_falls_back_to_host(sess):
    # eig of complex has no split-plane device path: host fallback, right
    # answer (the gather-retry invariant)
    src = """
A = [2+1i 0; 0 3-1i];
e = sort(real(gather(eig(gpuArray(A)))));
"""
    (e,) = run_get(sess, src, ["e"])
    assert np.max(np.abs(e.reshape(-1) - [2.0, 3.0])) < 1e-10


def test_supports_complex_without_child_process(monkeypatch):
    """Native complex is a plain property of the engine: true unless
    RUNMAT_TPU_COMPLEX_NATIVE=0, decided without starting any process."""
    from runmat_tpu.accel import init_engine, reset_engine, set_engine
    prev = _engine()
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: calls.append(a))
    try:
        reset_engine()
        monkeypatch.delenv("RUNMAT_TPU_COMPLEX_NATIVE", raising=False)
        assert init_engine(platform="cpu").supports_complex is True
        reset_engine()
        monkeypatch.setenv("RUNMAT_TPU_COMPLEX_NATIVE", "0")
        assert init_engine(platform="cpu").supports_complex is False
    finally:
        set_engine(prev)
    assert not calls
