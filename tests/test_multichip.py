"""Multi-chip sharding over the virtual 8-device CPU mesh.

Reference parity note (SURVEY.md §2.3): the reference is single-device; the
extension here is jax.sharding over a Mesh with XLA collectives. These
tests validate that the dp x tp sharded training step compiles + executes and
that parameters stay sharded (the driver's dryrun_multichip covers the same
path from the outside)."""

import jax
import numpy as np
import pytest

from runmat_tpu.parallel.mesh import (make_mesh, mlp_shardings, shard_params,
                                      sharded_train_step)
from runmat_tpu.dl.mlp import adam_init, init_mlp, mlp_forward


needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


@needs8
def test_mesh_factorization():
    mesh = make_mesh(8)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("data", "model")
    mesh2 = make_mesh(8, dp=4, tp=2)
    assert mesh2.devices.shape == (4, 2)


@needs8
def test_sharded_train_step_runs_and_updates():
    mesh = make_mesh(8)
    tp = mesh.devices.shape[1]
    sizes = [16, 32 * tp, 32 * tp, 8]
    n_layers = len(sizes) - 1
    step_fn, param_sh, batch_sh = sharded_train_step(mesh, n_layers)
    params = shard_params(init_mlp(0, sizes), param_sh)
    m, v = adam_init(params)
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((8, sizes[0]), dtype=np.float32),
                       batch_sh)
    y = jax.device_put(rng.standard_normal((8, sizes[-1]), dtype=np.float32),
                       batch_sh)
    import jax.numpy as jnp
    w_before = np.asarray(params[0][0])
    new_params, _opt, _step = step_fn(params, (m, v), x, y,
                                      jnp.zeros((), jnp.int32))
    jax.block_until_ready(new_params)
    w_after = np.asarray(new_params[0][0])
    assert not np.allclose(w_before, w_after)      # params moved
    # first-layer weight stays sharded on 'model': tp distinct column blocks
    # (replicated over dp, so every device holds a shard)
    col_starts = {s.index[1].start or 0
                  for s in new_params[0][0].addressable_shards}
    assert len(col_starts) == tp


@needs8
def test_sharded_forward_matches_single_device():
    mesh = make_mesh(8)
    tp = mesh.devices.shape[1]
    sizes = [8, 16 * tp, 4]
    params = init_mlp(1, sizes)
    x = np.random.default_rng(1).standard_normal((4, sizes[0]),
                                                 dtype=np.float32)
    ref = np.asarray(mlp_forward(params, x))
    param_sh, batch_sh = mlp_shardings(mesh, len(sizes) - 1)
    sharded = shard_params(params, param_sh)
    xs = jax.device_put(x, batch_sh)
    out = np.asarray(jax.jit(mlp_forward)(sharded, xs))
    assert np.allclose(out, ref, atol=1e-5)


# ----------------------------------------------- engine mesh mode (MATLAB)

@needs8
def test_engine_mesh_shards_matlab_arrays():
    """MATLAB arrays shard over the engine mesh; GSPMD propagates through
    lazy ops and reductions; parity vs single-device (VERDICT task 5)."""
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8, auto_offload=True,
                          offload_threshold=1024)
        eng.shard_threshold = 1024
        s = Session(accelerate=True)
        s.run_source("x = gpuArray(ones(8192, 1)); y = sin(x) + x .* 2; "
                     "t = sum(y);", "mesh")
        y = s.get("y")
        arr = eng.materialize(y.dev)
        from jax.sharding import PartitionSpec as P
        assert tuple(arr.sharding.spec)[0] == "data"
        np.testing.assert_allclose(s.get("t").host().ravel()[0],
                                   8192 * (np.sin(1.0) + 2.0), rtol=1e-12)
    finally:
        set_engine(prev)


@needs8
def test_distributed_builtin_and_gather():
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8)
        s = Session(accelerate=True)
        s.run_source("d = distributed(reshape(1:64, 8, 8)); "
                     "isd = isdistributed(d); c = gather(d * 2); "
                     "isg = isdistributed(gpuArray(1));", "dist")
        assert bool(s.get("isd").host())
        assert not bool(s.get("isg").host())
        np.testing.assert_allclose(
            s.get("c").host(),
            np.arange(1, 65).reshape(8, 8, order="F") * 2)
    finally:
        set_engine(prev)


@needs8
def test_mesh_device_loop_sharded_carry():
    """A device fori_loop with an RNG draw keeps the carry sharded and
    matches the single-device RNG stream exactly."""
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    src = ("rng(3); S = ones(16384, 1); "
           "for t = 1:8, S = S + randn(16384, 1) .* 0.01; end "
           "m = mean(S);")
    prev = active_engine()
    try:
        reset_engine()
        init_engine(platform="cpu", auto_offload=True, offload_threshold=1024)
        s1 = Session(accelerate=True)
        s1.run_source(src, "a")
        v1 = s1.get("S").host()
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8, auto_offload=True,
                          offload_threshold=1024)
        eng.shard_threshold = 1024
        s2 = Session(accelerate=True)
        s2.run_source(src, "b")
        np.testing.assert_allclose(s2.get("S").host(), v1, rtol=0, atol=0)
    finally:
        set_engine(prev)


@needs8
def test_engine_2d_mesh_sharded_gemm_parity():
    """VERDICT r2 #7: a MATLAB A*B over the 2-D ('data','model') engine mesh
    block-shards both operands, GSPMD inserts the collectives, and the
    result matches the host product exactly."""
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices="2x4",
                          auto_offload=True, offload_threshold=64)
        assert eng.mesh.devices.shape == (2, 4)
        assert eng.mesh.axis_names == ("data", "model")
        eng.shard_threshold = 64
        s = Session(accelerate=True)
        rng = np.random.default_rng(5)
        A = rng.standard_normal((16, 8))
        B = rng.standard_normal((8, 12))
        s.set("A", MatArray(A, "double"))
        s.set("B", MatArray(B, "double"))
        s.run_source("Ad = distributed(A); Bd = distributed(B); "
                     "Cd = Ad * Bd; C = gather(Cd); "
                     "sharded = isdistributed(Ad);", "gemm2d")
        assert bool(s.get("sharded").host())
        # operand really carries the 2-D block sharding
        arrA = eng.materialize(s.get("Ad").dev)
        assert tuple(arrA.sharding.spec) == ("data", "model")
        np.testing.assert_allclose(s.get("C").host(), A @ B, rtol=1e-12)
        # psum-backed reduction over the sharded product
        s.run_source("t = gather(sum(Cd(:)));", "gemm2d_sum")
        np.testing.assert_allclose(s.get("t").host().ravel()[0],
                                   (A @ B).sum(), rtol=1e-10)
    finally:
        set_engine(prev)


@needs8
def test_engine_2d_mesh_pagemtimes_parity():
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices="2x4",
                          auto_offload=True, offload_threshold=64)
        eng.shard_threshold = 64
        s = Session(accelerate=True)
        rng = np.random.default_rng(6)
        X = rng.standard_normal((8, 4, 6))
        Y = rng.standard_normal((4, 12, 6))
        s.set("X", MatArray(X, "double"))
        s.set("Y", MatArray(Y, "double"))
        s.run_source("Z = gather(pagemtimes(gpuArray(X), gpuArray(Y)));",
                     "pmt2d")
        ref = np.einsum("ikp,kjp->ijp", X, Y)
        np.testing.assert_allclose(s.get("Z").host(), ref, rtol=1e-12)
    finally:
        set_engine(prev)


@needs8
def test_sharded_axis_reductions_parity():
    """VERDICT r3 weak #3 / r4 #8: reduce the SHARDED axis of MATLAB
    reductions (the path where GSPMD must insert psum/reduce-scatter):
    sum/mean/std/median with and without omitnan, at shapes >= the shard
    threshold. Asserts the input really carries the 'data' sharding AND
    exact value parity vs the host."""
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8, auto_offload=True,
                          offload_threshold=1024)
        eng.shard_threshold = 1024
        s = Session(accelerate=True)
        rng = np.random.default_rng(11)
        X = rng.standard_normal((4096, 6))
        X[rng.integers(0, 4096, 64), rng.integers(0, 6, 64)] = np.nan
        s.set("X", MatArray(X, "double"))
        s.run_source(
            "Xd = distributed(X); "
            "s1 = gather(sum(Xd, 1)); "
            "s1o = gather(sum(Xd, 1, 'omitnan')); "
            "m1 = gather(mean(Xd, 1, 'omitnan')); "
            "sd = gather(std(Xd, 0, 1, 'omitnan')); "
            "md = gather(median(Xd, 1, 'omitnan')); "
            "mx = gather(max(Xd, [], 1)); "
            "tot = gather(sum(Xd(:), 'omitnan'));", "shred")
        arr = eng.materialize(s.get("Xd").dev)
        spec = tuple(arr.sharding.spec)
        assert spec and spec[0] == "data", f"X not sharded on dim 1: {spec}"
        np.testing.assert_allclose(
            s.get("s1").host().ravel(), X.sum(0), rtol=1e-12)
        np.testing.assert_allclose(
            s.get("s1o").host().ravel(), np.nansum(X, 0), rtol=1e-12)
        np.testing.assert_allclose(
            s.get("m1").host().ravel(), np.nanmean(X, 0), rtol=1e-12)
        np.testing.assert_allclose(
            s.get("sd").host().ravel(), np.nanstd(X, 0, ddof=1), rtol=1e-12)
        np.testing.assert_allclose(
            s.get("md").host().ravel(), np.nanmedian(X, 0), rtol=1e-12)
        np.testing.assert_allclose(
            s.get("mx").host().ravel(), np.nanmax(X, 0), rtol=1e-12)
        np.testing.assert_allclose(
            float(s.get("tot").host().ravel()[0]), np.nansum(X), rtol=1e-12)
    finally:
        set_engine(prev)


@needs8
def test_sharded_axis_scan_and_sort_parity():
    """cumsum along the sharded axis (associative scan across shards) and
    a full sort of a sharded matrix, value-exact vs host."""
    from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8, auto_offload=True,
                          offload_threshold=1024)
        eng.shard_threshold = 1024
        s = Session(accelerate=True)
        rng = np.random.default_rng(12)
        X = rng.standard_normal((4096, 4))
        s.set("X", MatArray(X, "double"))
        s.run_source(
            "Xd = distributed(X); "
            "c1 = gather(cumsum(Xd, 1)); "
            "c1r = gather(cumsum(Xd, 1, 'reverse')); "
            "cm = gather(cummax(Xd, 1)); "
            "[sv, si] = sort(Xd, 1); sv = gather(sv); si = gather(si); "
            "sd = gather(sort(Xd, 1, 'descend'));", "shscan")
        arr = eng.materialize(s.get("Xd").dev)
        assert tuple(arr.sharding.spec)[0] == "data"
        # sharded scans re-associate across shard boundaries: allow
        # rounding-level noise (values cross zero, so atol not rtol)
        np.testing.assert_allclose(s.get("c1").host(), X.cumsum(0),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(s.get("c1r").host(),
                                   X[::-1].cumsum(0)[::-1],
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(s.get("cm").host(),
                                   np.maximum.accumulate(X, 0), rtol=0)
        np.testing.assert_allclose(s.get("sv").host(), np.sort(X, 0),
                                   rtol=0)
        si = s.get("si").host().astype(int) - 1
        np.testing.assert_allclose(
            np.take_along_axis(X, si, 0), np.sort(X, 0), rtol=0)
        np.testing.assert_allclose(s.get("sd").host(), np.sort(X, 0)[::-1],
                                   rtol=0)
    finally:
        set_engine(prev)


@needs8
def test_sharded_fft_unique_linsolve_parity():
    """VERDICT r4 #6: the sharded-op sweep beyond GEMM/reductions — FFT
    along the sharded axis, unique over a sharded vector, and mldivide
    with a mesh-sharded RHS, all value-exact vs host with the input
    sharding asserted."""
    from runmat_tpu.accel import (active_engine, init_engine, reset_engine,
                                  set_engine)
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    prev = active_engine()
    try:
        reset_engine()
        eng = init_engine(platform="cpu", mesh_devices=8, auto_offload=True,
                          offload_threshold=512)
        eng.shard_threshold = 512
        s = Session(accelerate=True)
        rng = np.random.default_rng(21)
        F = rng.standard_normal((1024, 4))
        U = np.concatenate([rng.integers(0, 40, 4096).astype(np.float64),
                            [7.0, 7.0, 3.0]]).reshape(-1, 1)
        A = rng.standard_normal((64, 64)) + np.eye(64) * 64
        B = rng.standard_normal((64, 8))
        s.set("F", MatArray(F, "double"))
        s.set("U", MatArray(U, "double"))
        s.set("A", MatArray(A, "double"))
        s.set("B", MatArray(B, "double"))
        s.run_source(
            "Fd = distributed(F); "
            "fa = gather(abs(fft(Fd, [], 1))); "
            "fr = gather(real(ifft(fft(Fd, [], 1), [], 1))); "
            "Ud = distributed(U); uu = gather(unique(Ud)); "
            "Bd = distributed(B); X = gather(A \\ Bd);", "sweep")
        spec = tuple(eng.materialize(s.get("Fd").dev).sharding.spec)
        assert spec and spec[0] == "data", spec
        np.testing.assert_allclose(s.get("fa").host(),
                                   np.abs(np.fft.fft(F, axis=0)),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(s.get("fr").host(), F,
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(s.get("uu").host().ravel(),
                                   np.unique(U), rtol=0)
        np.testing.assert_allclose(s.get("X").host(),
                                   np.linalg.solve(A, B),
                                   rtol=1e-8, atol=1e-8)
    finally:
        set_engine(prev)
