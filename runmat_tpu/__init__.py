"""runmat_tpu — a MATLAB-compatible numerical computing runtime on JAX.

A from-scratch rebuild of the capabilities of runmat-org/runmat (a Rust +
wgpu/WGSL MATLAB runtime) on JAX: the compute path is jax/XLA under
`jax.jit`, fusion is traced-and-cached jaxprs instead of generated WGSL,
residency is jax device placement, and scale-out is `jax.sharding` over a Mesh.

Layer map (mirrors SURVEY.md §1):
  frontend/   lexer -> parser -> AST        (≙ runmat-lexer, runmat-parser)
  vm/         HIR-lite lowering + bytecode + interpreter (≙ runmat-hir/mir/vm)
  runtime/    builtin registry + builtin library         (≙ runmat-runtime)
  accel/      provider contract + jax engine + fusion    (≙ runmat-accelerate*)
  ops/        numeric kernels (counter RNG, FFT)         (≙ wgpu shaders)
  parallel/   mesh/sharding utilities (new capability)
  dl/         deep-learning toolbox                      (≙ builtins/deep_learning)
"""

__version__ = "0.1.0"


def cache_path(*parts: str) -> str:
    """A path under the checkout's git-ignored .cache directory, where the
    runtime keeps what it builds and records on its own: compiled
    executables, the warmup manifest, the native library."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".cache", *parts)


def __getattr__(name):
    # Lazy: importing runmat_tpu must not pull in jax (tests set platform env first).
    if name == "Session":
        from .session import Session
        return Session
    raise AttributeError(name)
