"""Multi-device mesh/sharding utilities.

Reference parity note (SURVEY.md §2.3): the reference is single-device; its
multi-device story is a provider registry keyed by device_id with explicit
upload/download. This runtime's extension is jax.sharding over a Mesh with XLA
collectives — this module provides the mesh construction and the sharded MLP
training step used by __graft_entry__.dryrun_multichip.

Sharding layout for the MLP train step:
  * dp ('data'):  batch dim of x/y; gradients all-reduce (psum) over dp.
  * tp ('model'): hidden dim of W1/W2 (column-, then row-sharded) — the
    classic Megatron 2-matmul pattern; XLA inserts the reduce-scatter/
    all-gather pair.
"""

from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int, dp: int = 0, tp: int = 0):
    """Create a Mesh over ('data', 'model') axes. If dp/tp are 0, pick the
    most-square factorization dp x tp with dp <= tp, so both the batch and
    the hidden dimension are split whenever n_devices is not prime."""
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:n_devices])
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    if not dp or not tp:
        dp = max(d for d in range(1, int(n_devices ** 0.5) + 1)
                 if n_devices % d == 0)
        tp = n_devices // dp
    return Mesh(devs.reshape(dp, tp), ("data", "model"))


def mlp_shardings(mesh, n_layers: int):
    """NamedShardings for params/opt-state/batch of dl.mlp.

    W1 sharded on output (model) dim, W2 on input (model) dim, alternating —
    so activations stay sharded on 'model' between the pair and only one
    collective pair per block is needed. Batch is sharded on 'data'."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    param_specs = []
    for i in range(n_layers):
        if i % 2 == 0:
            param_specs.append((P(None, "model"), P("model")))
        else:
            param_specs.append((P("model", None), P()))
    param_sh = [(NamedSharding(mesh, ws), NamedSharding(mesh, bs))
                for ws, bs in param_specs]
    batch_sh = NamedSharding(mesh, P("data", None))
    return param_sh, batch_sh


def shard_params(params, param_sh):
    import jax
    return [(jax.device_put(w, ws), jax.device_put(b, bs))
            for (w, b), (ws, bs) in zip(params, param_sh)]


def sharded_train_step(mesh, n_layers: int):
    """Return a jitted train step with explicit input/output shardings over the
    mesh (dp x tp). XLA inserts the psum/all-gather collectives."""
    import jax
    from ..dl.mlp import train_step

    param_sh, batch_sh = mlp_shardings(mesh, n_layers)
    params_tree = [tuple(s) for s in param_sh]
    opt_sh = (params_tree, params_tree)
    step_fn = jax.jit(
        train_step,
        in_shardings=(params_tree, opt_sh, batch_sh, batch_sh, None),
        out_shardings=(params_tree, opt_sh, None),
    )
    return step_fn, param_sh, batch_sh
