"""Fused device arrayfun/pagefun (an improvement over the
reference's host-execute-and-reupload arrayfun, gpu/arrayfun.rs:1-7)."""

import numpy as np

from helpers import run
from runmat_tpu.accel import active_engine


def test_arrayfun_anon_runs_fused_on_device():
    s = run("g = gpuArray(rand(1000, 1)); "
            "r = arrayfun(@(v) v^2 + sin(v)*3, g); "
            "ok = existsOnGPU(r); "
            "rh = gather(r); "
            "ref = g; refh = gather(ref).^2 + sin(gather(ref)).*3; "
            "err = max(abs(rh - refh));", accelerate=True)
    assert bool(np.asarray(s.get("ok").host()).reshape(-1)[0])
    assert float(np.asarray(s.get("err").host()).reshape(-1)[0]) < 1e-12


def test_arrayfun_fused_matches_slow_path_matrix_ops():
    # * / ^ ' on scalars must equal elementwise rewrites
    s = run("g = gpuArray((1:64)'/8); c = 2.5; "
            "fast = gather(arrayfun(@(v) (v*c)^2 / (1+v), g)); "
            "slow = arrayfun(@(v) (v*c)^2 / (1+v), gather(g)); "
            "err = max(abs(fast - slow));", accelerate=True)
    assert float(np.asarray(s.get("err").host()).reshape(-1)[0]) < 1e-12


def test_arrayfun_two_inputs_fused():
    s = run("a = gpuArray(rand(500,1)); b = gpuArray(rand(500,1)); "
            "r = gather(arrayfun(@(x,y) max(x, y) + hypot(x, y), a, b)); "
            "ref = max(gather(a), gather(b)) + hypot(gather(a), gather(b)); "
            "err = max(abs(r - ref));", accelerate=True)
    assert float(np.asarray(s.get("err").host()).reshape(-1)[0]) < 1e-12


def test_arrayfun_named_elementwise_handle():
    s = run("g = gpuArray(rand(256, 4)); r = arrayfun(@sin, g); "
            "ok = existsOnGPU(r); err = max(max(abs(gather(r) - "
            "sin(gather(g)))));", accelerate=True)
    assert bool(np.asarray(s.get("ok").host()).reshape(-1)[0])
    assert float(np.asarray(s.get("err").host()).reshape(-1)[0]) < 1e-12


def test_arrayfun_bails_on_branches_and_indexing():
    # data-dependent branch: falls back to per-element path, still correct
    s = run("g = gpuArray([-2; -1; 1; 2]); "
            "r = arrayfun(@(v) abs(v), g); "
            "A = [10 20 30 40]; "
            "ri = arrayfun(@(v) A(v), gpuArray([1 3])); rig = gather(ri);",
            accelerate=True)
    np.testing.assert_allclose(np.asarray(s.get("rig").host()).reshape(-1),
                               [10.0, 30.0])


def test_arrayfun_capture_scalar_fused_nonscalar_bails():
    s = run("c = 3; M = eye(2); g = gpuArray((1:10)'); "
            "r1 = gather(arrayfun(@(v) v*c, g)); "
            "e1 = max(abs(r1 - 3*(1:10)'));", accelerate=True)
    assert float(np.asarray(s.get("e1").host()).reshape(-1)[0]) < 1e-12


def test_arrayfun_transpose_conj_semantics():
    s = run("g = gpuArray([1+2i; 3-1i]); "
            "r = gather(arrayfun(@(v) v', g)); "
            "ref = conj(gather(g)); d = max(abs(r - ref));", accelerate=True)
    assert float(np.asarray(s.get("d").host()).reshape(-1)[0]) < 1e-12


def test_pagefun_mtimes_rides_pagemtimes():
    s = run("A = gpuArray(rand(8, 8, 5)); B = gpuArray(rand(8, 8, 5)); "
            "C = pagefun(@mtimes, A, B); Ch = gather(C); "
            "Ah = gather(A); Bh = gather(B); "
            "ref = pagemtimes(Ah, Bh); "
            "err = max(abs(Ch(:) - ref(:)));", accelerate=True)
    assert float(np.asarray(s.get("err").host()).reshape(-1)[0]) < 1e-10


def test_arrayfun_shape_mismatch_errors_before_fusing():
    from runmat_tpu.session import Session
    s = Session(accelerate=True)
    r = s.execute("arrayfun(@plus, gpuArray(ones(2,2)), gpuArray(ones(1,2)));")
    assert r.error is not None
    assert "same size" in r.error.message
