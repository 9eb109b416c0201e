"""page* batched-linalg family: pageinv/pagemldivide/pagenorm/pagectranspose
(device batched routes through accel/dense.py) and pagesvd/pagelu (host).

Device pages ride ONE batched jnp.linalg call on the stacked page axis —
one batched call — instead of a per-page loop (≙ the reference's
provider pagefun hooks, backend/wgpu/provider/ops/linalg/pagefun.rs).
"""

import numpy as np

from helpers import run_get

TOL = 1e-9


def pair(setup_host, setup_dev, body, names, tol=TOL):
    h = run_get(setup_host + body, *names)
    d = run_get(setup_dev + body, *names, accelerate=True)
    for n in names:
        hv, dv = h[n].host(), d[n].host()
        assert hv.shape == dv.shape, f"{n}: {hv.shape} vs {dv.shape}"
        np.testing.assert_allclose(dv, hv, rtol=tol, atol=tol, err_msg=n)
    return h


SETUP_H = ("rng(3); A = rand(6,6,4) + repmat(6*eye(6),1,1,4); "
           "B = rand(6,2,4);")
SETUP_D = ("rng(3); A = gpuArray(rand(6,6,4) + repmat(6*eye(6),1,1,4)); "
           "B = gpuArray(rand(6,2,4));")


def test_pageinv_parity_and_correctness():
    h = pair(SETUP_H, SETUP_D,
             "Ai = pageinv(A); E = pagemtimes(A, Ai);", ["Ai", "E"])
    e = h["E"].host()
    for k in range(e.shape[2]):
        np.testing.assert_allclose(e[:, :, k], np.eye(6), atol=1e-10)


def test_pagemldivide_square_parity():
    h = pair(SETUP_H, SETUP_D,
             "X = pagemldivide(A, B); R = pagemtimes(A, X) - B;",
             ["X", "R"])
    assert np.max(np.abs(h["R"].host())) < 1e-10


def test_pagemldivide_rectangular_lstsq():
    out = run_get("rng(0); A = rand(6,3,2); B = rand(6,2,2);"
                  "X = pagemldivide(A, B);", "X")
    a = run_get("rng(0); A = rand(6,3,2); B = rand(6,2,2);", "A", "B")
    for k in range(2):
        ref, *_ = np.linalg.lstsq(a["A"].host()[:, :, k],
                                  a["B"].host()[:, :, k], rcond=None)
        np.testing.assert_allclose(out["X"].host()[:, :, k], ref, atol=1e-10)


def test_pagenorm_orders_parity():
    for expr, ref_ord in [("pagenorm(A)", 2), ("pagenorm(A,1)", 1),
                          ("pagenorm(A,Inf)", np.inf),
                          ("pagenorm(A,'fro')", "fro")]:
        h = pair(SETUP_H, SETUP_D, f"n = {expr};", ["n"])
        n = h["n"].host()
        assert n.shape == (1, 1, 4)
        a = run_get(SETUP_H, "A")["A"].host()
        for k in range(4):
            np.testing.assert_allclose(
                n[0, 0, k], np.linalg.norm(a[:, :, k], ord=ref_ord),
                rtol=1e-10)


def test_pagectranspose_complex():
    out = run_get("A = complex(rand(2,3,2), rand(2,3,2));"
                  "B = pagectranspose(A); C = pagetranspose(A);", "A", "B", "C")
    a = out["A"].host()
    for k in range(2):
        np.testing.assert_allclose(out["B"].host()[:, :, k],
                                   a[:, :, k].conj().T)
        np.testing.assert_allclose(out["C"].host()[:, :, k], a[:, :, k].T)


def test_pagesvd_values_and_factors():
    out = run_get("rng(1); A = rand(4,3,2); s = pagesvd(A);"
                  "[U,S,V] = pagesvd(A);"
                  "R = pagemtimes(pagemtimes(U,S), pagectranspose(V)) - A;"
                  "[Ue,Se,Ve] = pagesvd(A,'econ');",
                  "s", "U", "S", "V", "R", "Ue", "Se", "Ve")
    assert out["s"].host().shape == (3, 1, 2)
    assert np.max(np.abs(out["R"].host())) < 1e-12
    assert out["U"].host().shape == (4, 4, 2)
    assert out["Ue"].host().shape == (4, 3, 2)
    a = run_get("rng(1); A = rand(4,3,2);", "A")["A"].host()
    for k in range(2):
        sv = np.linalg.svd(a[:, :, k], compute_uv=False)
        np.testing.assert_allclose(out["s"].host()[:, 0, k], sv, rtol=1e-12)


def test_pagelu_forms():
    out = run_get("rng(2); A = rand(5,5,3);"
                  "[L,U] = pagelu(A); R2 = pagemtimes(L,U) - A;"
                  "[L3,U3,P] = pagelu(A);"
                  "R3 = pagemtimes(P,A) - pagemtimes(L3,U3);"
                  "[L4,U4,pv] = pagelu(A,'vector');",
                  "R2", "R3", "L3", "pv")
    assert np.max(np.abs(out["R2"].host())) < 1e-12
    assert np.max(np.abs(out["R3"].host())) < 1e-12
    l3 = out["L3"].host()
    for k in range(3):
        assert np.allclose(np.triu(l3[:, :, k], 1), 0)  # unit lower
        np.testing.assert_allclose(np.diag(l3[:, :, k]), np.ones(5))
    assert out["pv"].host().shape == (5, 1, 3)


def test_page_family_single_page_matrix():
    out = run_get("A = magic(4) + 4*eye(4); Ai = pageinv(A);"
                  "n = pagenorm(A,'fro'); T = pagectranspose(A);",
                  "Ai", "n", "T")
    a = run_get("A = magic(4) + 4*eye(4);", "A")["A"].host()
    np.testing.assert_allclose(out["Ai"].host(), np.linalg.inv(a), atol=1e-12)
    assert out["n"].host().shape == (1, 1)
    np.testing.assert_allclose(out["T"].host(), a.T)
