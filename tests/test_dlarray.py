"""dlarray autodiff conformance: gradients, layers, losses, training loop.

≙ reference deep_learning tests (builtins/deep_learning/{autodiff,layers,
losses,training}.rs). The tape here is the engine's lazy DAG
differentiated by jax.grad (runmat_tpu/dl/autodiff.py)."""

import numpy as np
import pytest

from helpers import run
from runmat_tpu.errors import MatError
from runmat_tpu.session import Session


def dl_run(src):
    s = Session(accelerate=True)
    s.run_source(src, "t")
    return s


def test_grad_square():
    s = dl_run("""
function [loss, g] = f(x)
loss = sum(x .^ 2, 'all');
g = dlgradient(loss, x);
end
x = dlarray([1 2 3]);
[l, g] = dlfeval(@f, x);
gv = extractdata(g);
""")
    np.testing.assert_allclose(s.get("gv").host(), [[2, 4, 6]])


def test_grad_chain_rule_transcendental():
    s = dl_run("""
function [loss, g] = f(x)
loss = sum(sin(x) .* exp(x), 'all');
g = dlgradient(loss, x);
end
[l, g] = dlfeval(@f, dlarray([0.5 1.0]));
gv = extractdata(g);
""")
    x = np.array([0.5, 1.0])
    expect = np.cos(x) * np.exp(x) + np.sin(x) * np.exp(x)
    np.testing.assert_allclose(s.get("gv").host().reshape(-1), expect, rtol=1e-12)


def test_grad_matmul_multi_output():
    s = dl_run("""
function [loss, gw, gb] = f(w, b, x)
y = fullyconnect(x, w, b);
loss = sum(y .^ 2, 'all');
[gw, gb] = dlgradient(loss, w, b);
end
[l, gw, gb] = dlfeval(@f, dlarray([1 2; 3 4]), dlarray([0.5; -0.5]), dlarray([1; 2]));
gwv = extractdata(gw); gbv = extractdata(gb);
""")
    W = np.array([[1.0, 2], [3, 4]])
    b = np.array([[0.5], [-0.5]])
    x = np.array([[1.0], [2]])
    y = W @ x + b
    np.testing.assert_allclose(s.get("gwv").host(), 2 * y @ x.T)
    np.testing.assert_allclose(s.get("gbv").host(), 2 * y)


def test_grad_softmax_crossentropy():
    s = dl_run("""
function [loss, g] = f(w, x, t)
y = softmax(w * x);
loss = crossentropy(y, t);
g = dlgradient(loss, w);
end
[l, g] = dlfeval(@f, dlarray(single([0.1 0.2; 0.3 0.4])), dlarray(single([1; 2])), dlarray(single([1; 0])));
gv = extractdata(g);
""")
    g = s.get("gv").host()
    # softmax-CE gradient: (p - t) x'
    W = np.array([[0.1, 0.2], [0.3, 0.4]], np.float32)
    x = np.array([[1.0], [2.0]], np.float32)
    z = W @ x
    p = np.exp(z - z.max()) / np.exp(z - z.max()).sum()
    expect = (p - np.array([[1.0], [0.0]])) @ x.T
    np.testing.assert_allclose(g, expect, rtol=1e-4)


def test_grad_sigmoid_mse():
    s = dl_run("""
function [loss, g] = f(x)
loss = mse(sigmoid(x), 0.5 * ones(size(x)));
g = dlgradient(loss, x);
end
[l, g] = dlfeval(@f, dlarray([0.0 1.0]));
gv = extractdata(g);
""")
    x = np.array([0.0, 1.0])
    sg = 1 / (1 + np.exp(-x))
    expect = 2 * (sg - 0.5) * sg * (1 - sg) / x.size
    np.testing.assert_allclose(s.get("gv").host().reshape(-1), expect, rtol=1e-10)


def test_isdlarray_extractdata():
    s = dl_run("x = dlarray([1 2]); a = isdlarray(x); y = extractdata(x); "
               "b = isdlarray(y);")
    assert bool(s.get("a").host()[0, 0])
    assert not bool(s.get("b").host()[0, 0])


def test_dlgradient_requires_participation():
    s = Session(accelerate=True)
    with pytest.raises(MatError):
        s.run_source("""
function [loss, g] = f(x, z)
loss = sum(x .^ 2, 'all');
g = dlgradient(loss, z);
end
[l, g] = dlfeval(@f, dlarray([1 2]), dlarray([3 4]));
""", "t")


def test_training_loop_converges():
    """Linear regression via dlfeval/dlgradient/adamupdate must converge."""
    s = dl_run("""
rng(0);
n = 64;
X = [randn(1, n); ones(1, n)];
wtrue = [2.5; -1.0];
Y = wtrue' * X;
w = dlarray([0; 0]);
m = []; v = [];
for it = 1:200
  [loss, g] = dlfeval(@lossfn, w, dlarray(X), dlarray(Y));
  [w, m, v] = adamupdate(w, extractdata(g), m, v, it, 0.05);
  w = dlarray(w);
end
west = extractdata(w);
function [loss, g] = lossfn(w, X, Y)
pred = w' * X;
loss = mse(pred, Y);
g = dlgradient(loss, w);
end
""")
    west = s.get("west").host().reshape(-1)
    np.testing.assert_allclose(west, [2.5, -1.0], atol=0.05)


def test_sgdm_and_dlupdate():
    s = dl_run("""
[p, v] = sgdmupdate([1 2], [0.5 0.5], [], 0.1, 0.9);
q = dlupdate(@(x) x * 2, [3 4]);
""")
    np.testing.assert_allclose(s.get("p").host(), [[0.95, 1.95]])
    np.testing.assert_allclose(s.get("q").host(), [[6, 8]])


def test_losses():
    s = dl_run("a = l1loss([1 2], [2 4]); b = huber([0 3], [0 0], 1);")
    assert abs(float(s.get("a").host()[0, 0]) - 1.5) < 1e-12
    assert abs(float(s.get("b").host()[0, 0]) - 1.25) < 1e-12


def test_onnx_export_import_roundtrip(tmp_path):
    p = str(tmp_path / "m.onnx")
    s = dl_run(f"""
rng(0);
l1 = struct('type', 'fc', 'W', randn(4, 3), 'b', randn(4, 1));
l2 = struct('type', 'relu');
l3 = struct('type', 'fc', 'W', randn(2, 4), 'b', randn(2, 1));
l4 = struct('type', 'softmax');
model = struct('Layers', {{{{l1, l2, l3, l4}}}});
X = randn(3, 5);
y1 = predict(model, X);
exportONNXNetwork(model, '{p}');
model2 = importONNXNetwork('{p}');
y2 = predict(model2, X);
err = max(abs(y1(:) - y2(:)));
""".replace("{{{{", "{{").replace("}}}}", "}}"))
    assert float(s.get("err").host()[0, 0]) < 1e-5
    # the file leads with valid protobuf: ir_version field tag
    with open(p, "rb") as f:
        head = f.read(2)
    assert head[0] == 0x08      # field 1 varint (ir_version)
