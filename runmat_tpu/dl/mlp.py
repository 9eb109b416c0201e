"""Flagship model: jax MLP with a shardable training step.

Reference parity: runmat-runtime/src/builtins/deep_learning/ ({layers,losses,
training,model}.rs — tape-based reverse-mode autodiff + Adam provider hook).
Design on JAX: jax.grad IS the tape; the training step is one jitted
function; multi-device scale-out uses jax.sharding (dp over batch, tp over
the hidden dimension) — a new capability beyond the single-device reference
(SURVEY.md §2.3: the reference has no DP/TP; jax.sharding is the designated
extension).
"""

from __future__ import annotations

import functools

import numpy as np


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def init_mlp(seed: int, sizes: list[int], dtype=None):
    """Initialize MLP params: list of (W, b) with He init."""
    jax, jnp = _jax()
    dtype = dtype or jnp.float32
    key = jax.random.PRNGKey(seed)
    params = []
    for i in range(len(sizes) - 1):
        key, k1 = jax.random.split(key)
        w = jax.random.normal(k1, (sizes[i], sizes[i + 1]), dtype=dtype) \
            * np.sqrt(2.0 / sizes[i]).astype(np.float32)
        b = jnp.zeros((sizes[i + 1],), dtype=dtype)
        params.append((w, b))
    return params


def mlp_forward(params, x):
    """Forward pass: x (batch, in) -> logits (batch, out). Hidden matmuls run
    on the matrix units; batch and hidden dims that are multiples of 128
    tile fully."""
    _, jnp = _jax()
    h = x
    for i, (w, b) in enumerate(params):
        h = jnp.dot(h, w, preferred_element_type=jnp.float32) + b
        if i < len(params) - 1:
            h = jnp.maximum(h, 0.0)
    return h


def loss_fn(params, x, y):
    import jax
    _, jnp = _jax()
    logits = mlp_forward(params, x)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.sum(logp * y, axis=-1))


def adam_init(params):
    _, jnp = _jax()
    zeros = lambda p: jnp.zeros_like(p)
    import jax
    return (jax.tree_util.tree_map(zeros, params),
            jax.tree_util.tree_map(zeros, params))


def train_step(params, opt_state, x, y, step, lr=1e-3, beta1=0.9, beta2=0.999,
               eps=1e-8):
    """One Adam training step (pure function; jit/pjit-able)."""
    jax, jnp = _jax()
    m, v = opt_state
    grads = jax.grad(loss_fn)(params, x, y)
    step = step + 1
    m = jax.tree_util.tree_map(lambda a, g: beta1 * a + (1 - beta1) * g, m, grads)
    v = jax.tree_util.tree_map(lambda a, g: beta2 * a + (1 - beta2) * g * g, v, grads)
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    params = jax.tree_util.tree_map(
        lambda p, mm, vv: p - lr * (mm / bc1) / (jnp.sqrt(vv / bc2) + eps),
        params, m, v)
    return params, (m, v), step
