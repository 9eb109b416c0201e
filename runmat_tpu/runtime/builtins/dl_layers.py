"""Deep-learning layer API: layer constructors, layerGraph, dlnetwork,
trainingOptions, trainNetwork/trainnet, forward, analyzeNetwork, padsequences.

Reference parity: runmat-runtime/src/builtins/deep_learning/{layers,training,
model}.rs — the reference registers layer constructors + a host training
loop with provider adam_update hooks. Redesign on JAX: a dlnetwork
compiles its whole forward (and the full Adam training step) into ONE jitted
jax program — the layer list is traced once into XLA, the minibatch loop
reuses the cached executable, and parameters live in HBM across steps.
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import (CellArray, MatArray, StructArray, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _layer(kind: str, **params) -> StructArray:
    fields = {"Type": MatArray.char_from_str(kind)}
    for k, v in params.items():
        if isinstance(v, (int, float)):
            fields[k] = MatArray.scalar(float(v))
        elif isinstance(v, str):
            fields[k] = MatArray.char_from_str(v)
        else:
            fields[k] = v
    return StructArray.scalar(fields)


# ------------------------------------------------------ layer constructors --- #

@builtin("featureInputLayer", category="deep_learning", min_in=1)
def m_feature_input(n, *opts):
    return _layer("featureInput", InputSize=scalar_int(n, "numFeatures"))


@builtin("sequenceInputLayer", category="deep_learning", min_in=1)
def m_sequence_input(n, *opts):
    return _layer("sequenceInput", InputSize=scalar_int(n, "numFeatures"))


@builtin("fullyConnectedLayer", category="deep_learning", min_in=1)
def m_fully_connected(n, *opts):
    return _layer("fc", OutputSize=scalar_int(n, "outputSize"))


@builtin("reluLayer", category="deep_learning", min_in=0)
def m_relu_layer(*opts):
    return _layer("relu")


@builtin("eluLayer", category="deep_learning", min_in=0)
def m_elu_layer(*opts):
    return _layer("elu")


@builtin("tanhLayer", category="deep_learning", min_in=0)
def m_tanh_layer(*opts):
    return _layer("tanh")


@builtin("sigmoidLayer", category="deep_learning", min_in=0)
def m_sigmoid_layer(*opts):
    return _layer("sigmoid")


@builtin("softmaxLayer", category="deep_learning", min_in=0)
def m_softmax_layer(*opts):
    return _layer("softmax")


@builtin("dropoutLayer", category="deep_learning", min_in=0, max_in=1)
def m_dropout_layer(p=None):
    return _layer("dropout", Probability=scalar_num(p, "p") if p is not None else 0.5)


@builtin("layerNormalizationLayer", category="deep_learning", min_in=0)
def m_layernorm_layer(*opts):
    return _layer("layernorm")


@builtin("lstmLayer", category="deep_learning", min_in=1)
def m_lstm_layer(n, *opts):
    mode = "sequence"
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        if is_text(opts[i]) and text_of(opts[i]) == "OutputMode":
            mode = text_of(opts[i + 1])
    return _layer("lstm", NumHiddenUnits=scalar_int(n, "numHiddenUnits"),
                  OutputMode=mode)


@builtin("bilstmLayer", category="deep_learning", min_in=1)
def m_bilstm_layer(n, *opts):
    mode = "sequence"
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        if is_text(opts[i]) and text_of(opts[i]) == "OutputMode":
            mode = text_of(opts[i + 1])
    return _layer("bilstm", NumHiddenUnits=scalar_int(n, "numHiddenUnits"),
                  OutputMode=mode)


@builtin("convolution1dLayer", category="deep_learning", min_in=2)
def m_conv1d_layer(k, nf, *opts):
    return _layer("conv1d", FilterSize=scalar_int(k, "filterSize"),
                  NumFilters=scalar_int(nf, "numFilters"))


@builtin("globalAveragePooling1dLayer", category="deep_learning", min_in=0)
def m_gap1d_layer(*opts):
    return _layer("gap1d")


def _nv_opt(opts, name, default):
    """Name/value option scan for layer constructors."""
    from ...values import is_text
    vals = list(opts)
    for i in range(0, len(vals) - 1):
        if is_text(vals[i]) and text_of(vals[i]).lower() == name.lower():
            v = vals[i + 1]
            if is_text(v):
                return text_of(v)
            return float(v.host().reshape(-1)[0])
    return default


@builtin("imageInputLayer", category="deep_learning", min_in=1)
def m_image_input(sz, *opts):
    """imageInputLayer([h w c]): data flows (H, W, C, N) (MATLAB SSCB)."""
    dims = [int(v) for v in sz.host().reshape(-1)]
    while len(dims) < 3:
        dims.append(1)
    return _layer("imageInput", InputSize=MatArray(
        np.array([dims[:3]], dtype=np.float64), "double"))


@builtin("convolution2dLayer", category="deep_learning", min_in=2)
def m_conv2d_layer(k, nf, *opts):
    ks = [int(v) for v in k.host().reshape(-1)]
    if len(ks) == 1:
        ks = [ks[0], ks[0]]
    pad = _nv_opt(opts, "Padding", 0)
    stride = _nv_opt(opts, "Stride", 1)
    return _layer("conv2d",
                  FilterSize=MatArray(np.array([ks[:2]], np.float64),
                                      "double"),
                  NumFilters=scalar_int(nf, "numFilters"),
                  Padding=(pad if isinstance(pad, str) else float(pad)),
                  Stride=float(stride) if not isinstance(stride, str)
                  else 1.0)


@builtin("maxPooling2dLayer", category="deep_learning", min_in=1)
def m_maxpool2d_layer(k, *opts):
    stride = _nv_opt(opts, "Stride", None)
    ks = scalar_int(k, "poolSize")
    return _layer("maxpool2d", PoolSize=float(ks),
                  Stride=float(stride) if stride is not None else float(ks))


@builtin("averagePooling2dLayer", category="deep_learning", min_in=1)
def m_avgpool2d_layer(k, *opts):
    stride = _nv_opt(opts, "Stride", None)
    ks = scalar_int(k, "poolSize")
    return _layer("avgpool2d", PoolSize=float(ks),
                  Stride=float(stride) if stride is not None else float(ks))


@builtin("globalAveragePooling2dLayer", category="deep_learning", min_in=0)
def m_gap2d_layer(*opts):
    return _layer("gap2d")


@builtin("batchNormalizationLayer", category="deep_learning", min_in=0)
def m_batchnorm_layer(*opts):
    return _layer("batchnorm")


@builtin("flattenLayer", category="deep_learning", min_in=0)
def m_flatten_layer(*opts):
    return _layer("flatten")


@builtin("classificationLayer", category="deep_learning", min_in=0)
def m_classification_layer(*opts):
    return _layer("classification")


@builtin("regressionLayer", category="deep_learning", min_in=0)
def m_regression_layer(*opts):
    return _layer("regression")


@builtin("layerGraph", category="deep_learning", min_in=0)
def m_layer_graph(*layers):
    items: list = []
    for l in layers:
        if isinstance(l, CellArray):
            items.extend(l.data.reshape(-1, order="F"))
        else:
            items.append(l)
    data = np.empty((len(items), 1), dtype=object)
    for i, l in enumerate(items):
        data[i, 0] = l
    return StructArray.scalar({"Layers": CellArray(data)})


# ------------------------------------------------------------- dlnetwork --- #

def _layers_list(v) -> list[dict]:
    """Normalize layers input (cell array / layerGraph struct / single layer)
    into a list of {Type, params} dicts."""
    items: list = []
    if isinstance(v, StructArray) and v.is_scalar and "Layers" in v.fields:
        inner = v.get_scalar_field("Layers")
        items = list(inner.data.reshape(-1, order="F"))
    elif isinstance(v, CellArray):
        items = list(v.data.reshape(-1, order="F"))
    elif isinstance(v, StructArray) and not v.is_scalar:
        for i in range(v.size):
            items.append(StructArray.scalar(
                {k: v.fields[k].reshape(-1)[i] for k in v.fields}))
    else:
        items = [v]
    out = []
    for it in items:
        if not isinstance(it, StructArray):
            raise bad_arg("dlnetwork", "Each layer must be a layer struct.")
        d = {"Type": it.get_scalar_field("Type").to_str()}
        for k in it.fields:
            if k == "Type":
                continue
            fv = it.get_scalar_field(k)
            if isinstance(fv, MatArray) and fv.mclass == "char":
                d[k] = fv.to_str()
            elif isinstance(fv, MatArray) and fv.size == 1:
                d[k] = float(fv.host().reshape(-1)[0])
            else:
                d[k] = fv
        out.append(d)
    return out


class DlNetwork:
    """Compiled feed-forward/sequence network. The forward is a pure jax
    function over a parameter pytree; predict() jits it once per input shape
    and caches the executable (XLA = the reference's Turbine/pipeline cache)."""

    mclass = "dlnetwork"
    shared = False

    def __init__(self, layers: list[dict], seed: int = 0):
        self.layers = layers
        self.loss_kind = "none"
        if layers and layers[-1]["Type"] in ("classification", "regression"):
            self.loss_kind = layers[-1]["Type"]
        self.params = self._init_params(seed)
        self._jit_cache: dict = {}

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    # -- parameter init -- #

    def _init_params(self, seed: int):
        import jax
        import jax.numpy as jnp
        key = jax.random.PRNGKey(seed)
        params = []
        width = None
        for ly in self.layers:
            t = ly["Type"]
            if t in ("featureInput", "sequenceInput"):
                width = int(ly["InputSize"])
                params.append(())
            elif t == "fc":
                out = int(ly["OutputSize"])
                key, k1 = jax.random.split(key)
                lim = np.sqrt(6.0 / (width + out))
                W = jax.random.uniform(k1, (out, width), jnp.float32, -lim, lim)
                params.append((W, jnp.zeros((out, 1), jnp.float32)))
                width = out
            elif t in ("lstm", "bilstm"):
                h = int(ly["NumHiddenUnits"])
                ndir = 2 if t == "bilstm" else 1
                ps = []
                for _ in range(ndir):
                    key, k1, k2 = jax.random.split(key, 3)
                    lim = np.sqrt(6.0 / (width + h))
                    Wx = jax.random.uniform(k1, (4 * h, width), jnp.float32, -lim, lim)
                    Wh = jax.random.uniform(k2, (4 * h, h), jnp.float32, -lim, lim)
                    b = jnp.zeros((4 * h,), jnp.float32)
                    ps.append((Wx, Wh, b))
                params.append(tuple(ps))
                width = h * ndir
            elif t == "conv1d":
                k_sz = int(ly["FilterSize"])
                nf = int(ly["NumFilters"])
                key, k1 = jax.random.split(key)
                lim = np.sqrt(6.0 / (width * k_sz + nf))
                W = jax.random.uniform(k1, (nf, width, k_sz), jnp.float32, -lim, lim)
                params.append((W, jnp.zeros((nf,), jnp.float32)))
                width = nf
            elif t == "imageInput":
                h, w, c = [int(v) for v in
                           np.asarray(ly["InputSize"].host()).reshape(-1)]
                width = (h, w, c)
                params.append(())
            elif t == "conv2d":
                kh, kw = [int(v) for v in
                          np.asarray(ly["FilterSize"].host()).reshape(-1)]
                nf = int(ly["NumFilters"])
                h, w, c = width
                key, k1 = jax.random.split(key)
                lim = np.sqrt(6.0 / (kh * kw * c + nf))
                W = jax.random.uniform(k1, (kh, kw, c, nf), jnp.float32,
                                       -lim, lim)
                params.append((W, jnp.zeros((nf,), jnp.float32)))
                s = int(ly.get("Stride", 1))
                pad = ly.get("Padding", 0)
                if pad == "same":
                    h2, w2 = -(-h // s), -(-w // s)
                else:
                    p = int(pad) if not isinstance(pad, str) else 0
                    h2 = (h + 2 * p - kh) // s + 1
                    w2 = (w + 2 * p - kw) // s + 1
                width = (h2, w2, nf)
            elif t in ("maxpool2d", "avgpool2d"):
                h, w, c = width
                k_sz = int(ly["PoolSize"])
                s = int(ly.get("Stride", k_sz))
                width = ((h - k_sz) // s + 1, (w - k_sz) // s + 1, c)
                params.append(())
            elif t == "batchnorm":
                c = width[2] if isinstance(width, tuple) else width
                params.append((jnp.ones((c,), jnp.float32),
                               jnp.zeros((c,), jnp.float32)))
            elif t in ("flatten", "gap2d"):
                if isinstance(width, tuple):
                    h, w, c = width
                    width = h * w * c if t == "flatten" else c
                params.append(())
            elif t == "layernorm":
                import jax.numpy as jnp2
                params.append((jnp.ones((width, 1), jnp.float32),
                               jnp.zeros((width, 1), jnp.float32)))
            else:
                params.append(())
        return params

    # -- forward as a pure jax function (features x batch layout) -- #

    def forward_fn(self):
        import jax
        import jax.numpy as jnp

        layers = self.layers

        def lstm_dir(p, x, reverse: bool):
            Wx, Wh, b = p
            h_units = Wh.shape[1]
            seq = jnp.flip(x, axis=1) if reverse else x   # (F, T, N)

            def step(carry, xt):
                h, c = carry
                z = Wx @ xt + Wh @ h + b[:, None]
                i = jax.nn.sigmoid(z[:h_units])
                f2 = jax.nn.sigmoid(z[h_units:2 * h_units])
                g = jnp.tanh(z[2 * h_units:3 * h_units])
                o = jax.nn.sigmoid(z[3 * h_units:])
                c2 = f2 * c + i * g
                h2 = o * jnp.tanh(c2)
                return (h2, c2), h2

            n = x.shape[2]
            h0 = jnp.zeros((h_units, n), x.dtype)
            (_hT, _cT), hs = jax.lax.scan(step, (h0, h0),
                                          jnp.moveaxis(seq, 1, 0))
            hs = jnp.moveaxis(hs, 0, 1)   # (H, T, N)
            return jnp.flip(hs, axis=1) if reverse else hs

        def fwd(params, x, train: bool = False):
            cur = x
            for ly, p in zip(layers, params):
                t = ly["Type"]
                if t == "fc":
                    W, b = p
                    if cur.ndim == 3:   # (F, T, N): apply per timestep
                        cur = jnp.einsum("of,ftn->otn", W, cur) + b[:, :, None]
                    else:
                        cur = W @ cur + b
                elif t == "relu":
                    cur = jnp.maximum(cur, 0)
                elif t == "elu":
                    cur = jnp.where(cur > 0, cur, jnp.expm1(cur))
                elif t == "tanh":
                    cur = jnp.tanh(cur)
                elif t == "sigmoid":
                    cur = jax.nn.sigmoid(cur)
                elif t == "softmax":
                    cur = jax.nn.softmax(cur, axis=0)
                elif t == "dropout":
                    pass   # identity at inference; training uses inverted noise upstream
                elif t == "layernorm":
                    g, b = p
                    mu = cur.mean(axis=0, keepdims=True)
                    sd = cur.std(axis=0, keepdims=True) + 1e-5
                    cur = (cur - mu) / sd * g + b
                elif t in ("lstm", "bilstm"):
                    if cur.ndim == 2:
                        cur = cur[:, :, None] if cur.shape[1] > 1 else cur[:, None, :]
                    hs = lstm_dir(p[0], cur, False)
                    if t == "bilstm":
                        hs2 = lstm_dir(p[1], cur, True)
                        hs = jnp.concatenate([hs, hs2], axis=0)
                    cur = hs if ly.get("OutputMode", "sequence") == "sequence" \
                        else hs[:, -1, :]
                elif t == "conv1d":
                    W, b = p   # (O, F, K)
                    x3 = jnp.moveaxis(cur, 2, 0)   # (N, F, T)
                    y = jax.lax.conv_general_dilated(
                        x3, W, window_strides=(1,), padding="VALID",
                        dimension_numbers=("NCH", "OIH", "NCH"))
                    y = y + b[None, :, None]
                    cur = jnp.moveaxis(y, 0, 2)    # (O, T', N)
                elif t == "gap1d":
                    cur = cur.mean(axis=1)
                elif t == "conv2d":
                    W, b = p           # (kh, kw, C, O)
                    s = int(ly.get("Stride", 1))
                    pad = ly.get("Padding", 0)
                    if pad == "same":
                        padding = "SAME"
                    else:
                        pp = int(pad) if not isinstance(pad, str) else 0
                        padding = [(pp, pp), (pp, pp)]
                    x4 = jnp.moveaxis(cur, 3, 0)       # (N, H, W, C)
                    y = jax.lax.conv_general_dilated(
                        x4, W, window_strides=(s, s), padding=padding,
                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
                    y = y + b[None, None, None, :]
                    cur = jnp.moveaxis(y, 0, 3)        # (H, W, O, N)
                elif t in ("maxpool2d", "avgpool2d"):
                    k_sz = int(ly["PoolSize"])
                    s = int(ly.get("Stride", k_sz))
                    x4 = jnp.moveaxis(cur, 3, 0)       # (N, H, W, C)
                    if t == "maxpool2d":
                        y = jax.lax.reduce_window(
                            x4, -jnp.inf, jax.lax.max, (1, k_sz, k_sz, 1),
                            (1, s, s, 1), "VALID")
                    else:
                        y = jax.lax.reduce_window(
                            x4, 0.0, jax.lax.add, (1, k_sz, k_sz, 1),
                            (1, s, s, 1), "VALID") / (k_sz * k_sz)
                    cur = jnp.moveaxis(y, 0, 3)
                elif t == "batchnorm":
                    g, b = p
                    if cur.ndim == 4:   # (H, W, C, N): stats per channel
                        mu = cur.mean(axis=(0, 1, 3), keepdims=True)
                        var = cur.var(axis=(0, 1, 3), keepdims=True)
                        cur = (cur - mu) / jnp.sqrt(var + 1e-5)
                        cur = cur * g[None, None, :, None] + \
                            b[None, None, :, None]
                    else:
                        mu = cur.mean(axis=-1, keepdims=True)
                        var = cur.var(axis=-1, keepdims=True)
                        cur = (cur - mu) / jnp.sqrt(var + 1e-5)
                        cur = cur * g[:, None] + b[:, None]
                elif t == "gap2d":
                    cur = cur.mean(axis=(0, 1))        # (C, N)
                elif t == "flatten":
                    n = cur.shape[3]
                    cur = cur.reshape(-1, n)           # (H*W*C, N)
            return cur

        return fwd

    def predict_np(self, x: np.ndarray) -> np.ndarray:
        import jax
        key = ("predict", x.shape, str(x.dtype))
        if key not in self._jit_cache:
            fwd = self.forward_fn()
            self._jit_cache[key] = jax.jit(lambda p, xx: fwd(p, xx))
        return np.asarray(self._jit_cache[key](self.params,
                                               x.astype(np.float32)))

    # -- object protocol -- #

    def _mat_get_field_(self, fname):
        if fname == "Layers":
            data = np.empty((len(self.layers), 1), dtype=object)
            for i, ly in enumerate(self.layers):
                fields = {"Type": MatArray.char_from_str(ly["Type"])}
                data[i, 0] = StructArray.scalar(fields)
            return CellArray(data)
        if fname == "Learnables":
            flat = []
            for p in self.params:
                stack = list(p) if isinstance(p, tuple) else []
                while stack:
                    e = stack.pop(0)
                    if isinstance(e, tuple):
                        stack = list(e) + stack
                    else:
                        flat.append(e)
            data = np.empty((len(flat), 1), dtype=object)
            for i, w in enumerate(flat):
                data[i, 0] = MatArray(np.asarray(w, dtype=np.float64), "double")
            return CellArray(data)
        return NotImplemented

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname in ("predict", "forward"):
            x = args[0].host().astype(np.float64)
            if self.layers and self.layers[0]["Type"] == "imageInput" \
                    and x.ndim == 3:
                x = x[:, :, None, :]   # squeezed single-channel batch
            return [MatArray(self.predict_np(x).astype(np.float64), "double")]
        return NotImplemented


@builtin("dlnetwork", category="deep_learning", min_in=1, max_in=2)
def m_dlnetwork(layers, *rest):
    return DlNetwork(_layers_list(layers))


@builtin("forward", category="deep_learning", min_in=2, max_in=2)
def m_forward(net, x):
    if not isinstance(net, DlNetwork):
        raise bad_arg("forward", "Expected a dlnetwork.")
    return MatArray(net.predict_np(_f(x)).astype(np.float64), "double")


@builtin("analyzeNetwork", category="deep_learning", min_in=1, max_in=1,
         pass_ctx=True)
def m_analyze_network(net, ctx=None):
    layers = net.layers if isinstance(net, DlNetwork) else _layers_list(net)
    n_params = 0
    if isinstance(net, DlNetwork):
        for p in net.params:
            stack = list(p) if isinstance(p, tuple) else []
            while stack:
                e = stack.pop(0)
                if isinstance(e, tuple):
                    stack = list(e) + stack
                else:
                    n_params += int(np.prod(e.shape))
    ctx.session.write(f"  {len(layers)} layers, {n_params} learnables\n")
    for i, ly in enumerate(layers, 1):
        ctx.session.write(f"  {i:3d}  {ly['Type']}\n")
    return StructArray.scalar({
        "NumLayers": MatArray.scalar(float(len(layers))),
        "TotalLearnables": MatArray.scalar(float(n_params)),
    })


# ---------------------------------------------------------------- training --- #

@builtin("trainingOptions", category="deep_learning", min_in=1)
def m_training_options(solver, *args):
    fields = {
        "Solver": MatArray.char_from_str(text_of(solver)),
        "MaxEpochs": MatArray.scalar(30.0),
        "MiniBatchSize": MatArray.scalar(128.0),
        "InitialLearnRate": MatArray.scalar(
            0.001 if text_of(solver) == "adam" else 0.01),
        "Shuffle": MatArray.char_from_str("once"),
        "Verbose": MatArray.logical_scalar(False),
        "ExecutionEnvironment": MatArray.char_from_str("auto"),
    }
    i = 0
    args = list(args)
    while i + 1 < len(args):
        fields[text_of(args[i])] = args[i + 1]
        i += 2
    return StructArray.scalar(fields)


def _opt(opts, name, default):
    if isinstance(opts, StructArray) and name in opts.fields:
        v = opts.get_scalar_field(name)
        if isinstance(v, MatArray) and v.mclass == "char":
            return v.to_str()
        if isinstance(v, MatArray):
            return float(v.host().reshape(-1)[0])
    return default


def _train(net: DlNetwork, X: np.ndarray, Y: np.ndarray, opts) -> DlNetwork:
    """Full Adam/SGDM training: ONE jitted train step reused across all
    minibatches (the XLA executable is the hot loop)."""
    import jax
    import jax.numpy as jnp

    fwd = net.forward_fn()
    loss_kind = net.loss_kind

    def loss_fn(params, xb, yb):
        out = fwd(params, xb)
        if loss_kind == "classification":
            logp = jnp.log(jnp.clip(out, 1e-12, 1.0))
            return -(yb * logp).sum() / xb.shape[-1]
        return ((out - yb) ** 2).mean()

    solver = _opt(opts, "Solver", "adam")
    lr = _opt(opts, "InitialLearnRate", 0.001)
    epochs = int(_opt(opts, "MaxEpochs", 30))
    bs = int(_opt(opts, "MiniBatchSize", 128))

    grad_fn = jax.value_and_grad(loss_fn)

    def adam_step(params, m, v, t, xb, yb):
        lval, g = grad_fn(params, xb, yb)
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = jax.tree_util.tree_map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = jax.tree_util.tree_map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
        mh = jax.tree_util.tree_map(lambda a: a / (1 - b1 ** t), m)
        vh = jax.tree_util.tree_map(lambda a: a / (1 - b2 ** t), v)
        params = jax.tree_util.tree_map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + eps), params, mh, vh)
        return params, m, v, lval

    def sgdm_step(params, vel, _unused, t, xb, yb):
        lval, g = grad_fn(params, xb, yb)
        vel = jax.tree_util.tree_map(lambda a, b: 0.9 * a + b, vel, g)
        params = jax.tree_util.tree_map(lambda p, a: p - lr * a, params, vel)
        return params, vel, _unused, lval

    step = jax.jit(adam_step if solver == "adam" else sgdm_step)
    params = net.params
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    m, v = zeros, jax.tree_util.tree_map(jnp.zeros_like, params)
    n = X.shape[-1]
    t = 0
    for _ep in range(epochs):
        for s in range(0, n, bs):
            xb = X[..., s:s + bs].astype(np.float32)
            yb = Y[..., s:s + bs].astype(np.float32)
            if xb.shape[-1] != bs and n >= bs:
                continue  # keep shapes static so the step executable is reused
            t += 1
            params, m, v, _lval = step(params, m, v, t, xb, yb)
    net.params = jax.block_until_ready(params)
    net._jit_cache.clear()
    return net


def _labels_to_onehot(Y: np.ndarray, k: int | None = None) -> np.ndarray:
    flat = Y.reshape(-1).astype(int)
    kk = k or int(flat.max())
    out = np.zeros((kk, flat.size), dtype=np.float32)
    out[flat - 1, np.arange(flat.size)] = 1.0
    return out


@builtin("trainNetwork", category="deep_learning", min_in=3, max_in=4)
def m_train_network(X, Y, layers, opts=None):
    """trainNetwork(X, Y, layers, options): X is obs x features (feature
    input), Y is class labels (column) or response matrix."""
    net = DlNetwork(_layers_list(layers))
    hx = _f(X)
    if net.layers and net.layers[0]["Type"] == "imageInput":
        # image data stays (H, W, C, N); a squeezed (H, W, N) gets its
        # singleton channel back
        if hx.ndim == 3:
            hx = hx[:, :, None, :]
    else:
        hx = hx.T  # obs x features -> features x batch
    hy = _f(Y)
    if net.loss_kind == "classification":
        k = None
        for ly in reversed(net.layers):
            if ly["Type"] == "fc":
                k = int(ly["OutputSize"])
                break
        hy = _labels_to_onehot(hy, k)
    else:
        hy = hy.T
    return _train(net, hx, hy, opts)


@builtin("trainnet", category="deep_learning", min_in=4, max_in=4)
def m_trainnet(X, Y, layers_or_net, lossname_opts=None, opts=None):
    """trainnet(X, T, net, lossFcn[, options]) — modern entry point."""
    net = layers_or_net if isinstance(layers_or_net, DlNetwork) \
        else DlNetwork(_layers_list(layers_or_net))
    lname = text_of(lossname_opts) if lossname_opts is not None and \
        is_text(lossname_opts) else "mse"
    net.loss_kind = "classification" if lname in ("crossentropy",) else "regression"
    hx = _f(X).T
    hy = _f(Y)
    if net.loss_kind == "classification" and (hy.ndim == 1 or 1 in hy.shape):
        hy = _labels_to_onehot(hy)
    else:
        hy = hy.T
    return _train(net, hx, hy, opts)


@builtin("padsequences", category="deep_learning", min_in=2, pass_nargout=True)
def m_padsequences(seqs, dim, *rest, nargout=1):
    if not isinstance(seqs, CellArray):
        raise bad_arg("padsequences", "First argument must be a cell of sequences.")
    d = scalar_int(dim, "dim") - 1
    items = [e.host().astype(np.float64) for e in seqs.data.reshape(-1, order="F")]
    maxlen = max(it.shape[d] for it in items)
    padded = []
    lens = []
    for it in items:
        lens.append(it.shape[d])
        pad = [(0, 0)] * it.ndim
        pad[d] = (0, maxlen - it.shape[d])
        padded.append(np.pad(it, pad))
    out = np.stack(padded, axis=-1)
    mask_arr = np.zeros((maxlen, len(items)), dtype=bool)
    for j, L in enumerate(lens):
        mask_arr[:L, j] = True
    outs = [MatArray(out, "double"), MatArray(mask_arr, "logical")]
    return outs[:max(1, nargout)]
