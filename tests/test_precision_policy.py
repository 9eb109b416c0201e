"""Matmul precision policy (VERDICT r2 #1).

MATLAB `single` GEMM must run at true-f32 product precision by default —
JAX's default precision multiplies f32 operands at reduced precision (TF32
on an NVIDIA GPU, ~13 mantissa bits lost). The policy mirrors the reference's opt-in downcast guard
(runmat-accelerate/src/precision.rs:31-60): default 'highest', opt-in to
'high'/'bf16' via RUNMAT_TPU_MATMUL_PRECISION or
RUNMAT_TPU_ALLOW_PRECISION_DOWNCAST=1 or the accelerate.matmul_precision
config knob. On the CPU backend the precision argument is accepted and
products are always true f32, so these tests pin the *plumbing* (policy
resolution, cache keying, correctness); the reduced-vs-f32 numeric gap is
pinned on the card by chip_smoke.py's precision phase.
"""

import numpy as np

from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine
from runmat_tpu.session import Session


def _fresh_engine(**kw):
    prev = active_engine()
    reset_engine()
    eng = init_engine(platform="cpu", **kw)
    return prev, eng


def test_default_policy_is_highest():
    prev, eng = _fresh_engine()
    try:
        assert eng.matmul_precision == "highest"
        from jax import lax
        assert eng.mm_precision() == lax.Precision.HIGHEST
    finally:
        set_engine(prev)


def test_env_optin_downcast(monkeypatch):
    monkeypatch.setenv("RUNMAT_TPU_ALLOW_PRECISION_DOWNCAST", "1")
    prev, eng = _fresh_engine()
    try:
        assert eng.matmul_precision == "bf16"
        from jax import lax
        assert eng.mm_precision() == lax.Precision.DEFAULT
    finally:
        set_engine(prev)


def test_env_explicit_precision(monkeypatch):
    monkeypatch.setenv("RUNMAT_TPU_MATMUL_PRECISION", "high")
    prev, eng = _fresh_engine()
    try:
        assert eng.matmul_precision == "high"
        from jax import lax
        assert eng.mm_precision() == lax.Precision.HIGH
    finally:
        set_engine(prev)


def test_ctor_knob_vs_env_precedence(monkeypatch):
    # env wins over the config/ctor value (config.py precedence contract)
    monkeypatch.setenv("RUNMAT_TPU_MATMUL_PRECISION", "bf16")
    prev, eng = _fresh_engine(matmul_precision="highest")
    try:
        assert eng.matmul_precision == "bf16"
    finally:
        set_engine(prev)
    # without the env var, the ctor/config value applies
    monkeypatch.delenv("RUNMAT_TPU_MATMUL_PRECISION")
    prev2, eng2 = _fresh_engine(matmul_precision="high")
    try:
        assert eng2.matmul_precision == "high"
    finally:
        set_engine(prev)


def test_precision_in_executable_cache_key():
    """Switching policy mid-session must not reuse the old executable."""
    prev, eng = _fresh_engine()
    try:
        s = Session(accelerate=True)
        s.run_source("A = gpuArray(single(magic(8))); C = A*A; "
                     "g = gather(C);", "t")
        c1 = eng.stats["compiles"]
        eng.matmul_precision = "bf16"
        s.run_source("C2 = A*A; g2 = gather(C2);", "t")
        assert eng.stats["compiles"] > c1
        # same policy again: cache hit, no new compile
        c2 = eng.stats["compiles"]
        s.run_source("C3 = A*A; g3 = gather(C3);", "t")
        assert eng.stats["compiles"] == c2
    finally:
        set_engine(prev)


def test_single_gemm_matches_host_f32():
    """Device single GEMM == numpy f32 GEMM bit-for-bit tolerance on the
    CPU backend; on the GPU in parity mode this same bound holds
    (chip_smoke.py enforces it on the card)."""
    prev, eng = _fresh_engine()
    try:
        s = Session(accelerate=True)
        s.run_source("rng(7); A = single(rand(64)); B = single(rand(64)); "
                     "Cd = gather(gpuArray(A) * gpuArray(B)); Ch = A * B; "
                     "err = max(abs(Cd(:) - Ch(:)));", "t")
        assert float(np.asarray(s.get("err").host()).ravel()[0]) < 1e-4
    finally:
        set_engine(prev)


def test_pagemtimes_rides_policy():
    prev, eng = _fresh_engine()
    try:
        s = Session(accelerate=True)
        s.run_source("X = gpuArray(single(reshape(1:24, 2, 3, 4))); "
                     "Y = gpuArray(single(reshape(1:36, 3, 3, 4))); "
                     "Z = gather(pagemtimes(X, Y)); sz = size(Z);", "t")
        assert tuple(np.asarray(s.get("sz").host()).ravel()) == (2.0, 3.0, 4.0)
    finally:
        set_engine(prev)


# --------------------------------------------------------------------- ozaki

def test_ozaki_digits_reconstruct():
    """Digit split is an (almost-)error-free transformation: scale *
    sum(d_i * 2^-7(i+1)) == x to 2^-42 * rowscale."""
    import jax.numpy as jnp
    from runmat_tpu.accel import ozaki
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((64, 128)) *
                    np.exp(rng.uniform(-20, 20, (64, 128))))
    scale, digs = ozaki._digits_along(jnp, x, axis=1)
    rec = sum(np.asarray(d, dtype=np.float64) * 2.0 ** (-7 * (i + 1))
              for i, d in enumerate(digs))
    err = np.abs(np.asarray(scale) * rec - np.asarray(x))
    assert np.all(err <= np.asarray(scale) * 2.0 ** -42)


def test_ozaki_gemm_rtol_1e10_K8192():
    """VERDICT r4 gate: compensated f64 GEMM with inner dim 8192 matches a
    host f64 GEMM to better than 1e-10 relative."""
    import jax.numpy as jnp
    from runmat_tpu.accel import ozaki
    rng = np.random.default_rng(11)
    M, K, N = 96, 8192, 80
    A = rng.standard_normal((M, K))
    B = rng.standard_normal((K, N))
    C = np.asarray(ozaki.gemm_f64(jnp, jnp.asarray(A), jnp.asarray(B)))
    ref = A @ B
    rel = np.max(np.abs(C - ref)) / np.max(np.abs(ref))
    assert rel < 1e-10, rel


def test_ozaki_gemm_wide_dynamic_range():
    """Per-row/column power-of-two scaling keeps accuracy across 10^12 of
    magnitude spread between rows/columns."""
    import jax.numpy as jnp
    from runmat_tpu.accel import ozaki
    rng = np.random.default_rng(3)
    M, K, N = 32, 512, 24
    A = rng.standard_normal((M, K)) * (10.0 ** rng.uniform(-6, 6, (M, 1)))
    B = rng.standard_normal((K, N)) * (10.0 ** rng.uniform(-6, 6, (1, N)))
    C = np.asarray(ozaki.gemm_f64(jnp, jnp.asarray(A), jnp.asarray(B)))
    ref = A @ B
    err = np.abs(C - ref)
    # The scheme's guarantee is ABSOLUTE per entry: truncating digits at
    # 2^-42 of the row/column scale bounds |err_ij| by
    # O(K * 2^-42 * scale_i * scale_j); entries that cancel to far below
    # their scale product cannot promise elementwise-relative accuracy
    # (true of any fixed-digit compensated scheme).
    sa = 4.0 * np.max(np.abs(A), axis=1, keepdims=True)   # >= true scales
    sb = 4.0 * np.max(np.abs(B), axis=0, keepdims=True)
    bound = K * 2.0 ** -42 * sa * sb
    assert np.all(err <= bound), np.max(err / bound)
    # and typical entries are still ~1e-12 relative
    rel = err / np.maximum(np.abs(ref), 1e-300)
    assert np.median(rel) < 1e-11, np.median(rel)


def test_ozaki_gemm_nonfinite_rows_nan():
    import jax.numpy as jnp
    from runmat_tpu.accel import ozaki
    A = np.array([[1.0, np.inf], [3.0, 4.0]])
    B = np.array([[1.0, 2.0], [3.0, np.nan]])
    C = np.asarray(ozaki.gemm_f64(jnp, jnp.asarray(A), jnp.asarray(B)))
    assert np.isnan(C[0]).all()          # bad row of A
    assert np.isnan(C[:, 1]).all()       # bad col of B
    np.testing.assert_allclose(C[1, 0], 15.0)


def test_ozaki_policy_engine_path():
    """RUNMAT_TPU_MATMUL_PRECISION=ozaki routes device double GEMM through
    the compensated kernel with full MATLAB-surface parity."""
    prev, eng = _fresh_engine(matmul_precision="ozaki")
    try:
        assert eng.matmul_precision == "ozaki"
        s = Session(accelerate=True)
        s.execute("rng(5); A = rand(200) - 0.5; B = rand(200) - 0.5; "
                  "C = gather(gpuArray(A) * gpuArray(B)); "
                  "Ch = A * B; err = max(abs(C(:) - Ch(:)));")
        err = float(np.asarray(s.get("err").host()).ravel()[0])
        assert err < 1e-10, err
    finally:
        set_engine(prev)


def test_default_policy_keeps_f64_gemm_native():
    """f64 GEMMs of any size keep the session policy in the op static:
    the compensated int8 path runs only under the explicit 'ozaki' policy
    (on the H100 native f64 is both faster and exact; PERF.md)."""
    from runmat_tpu.values import MatArray
    prev, eng = _fresh_engine()
    try:
        s = Session(accelerate=True)
        A = np.random.default_rng(8).standard_normal((300, 300))
        s.set("A", MatArray(A, "double"))
        s.run_source("Ad = gpuArray(A); C = Ad * Ad;", "t")
        node = s.get("C").dev
        assert node.op == "matmul" and node.static == ("float64", "highest")
        ref = A @ A
        assert np.max(np.abs(s.get("C").host() - ref)) < 1e-12 * np.max(
            np.abs(ref))
    finally:
        set_engine(prev)
