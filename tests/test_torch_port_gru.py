"""The port's GRU against the JAX package's: the recurrence alone against
the Pallas kernel (interpret mode), single-direction layers against JAX
``GRULayer`` on both its Pallas and scan paths, and the stacked BiGRU; then
the gradient, the recurrence's plain backward against ``jax.vjp`` of the
Pallas kernel's ``custom_vjp``, whole layers' gradients against ``jax.vjp``
of both JAX paths, and the stacked BiGRU's gradients (through the
bidirectional autograd function) against ``jax.vjp`` of JAX ``BiGRU``.

Tolerance rtol 1e-5, atol 1e-6 for outputs, rtol 1e-4, atol 1e-5 for
gradients (the Pallas kernel's own tests, tests/test_pallas_gru.py): both
sides are float32 and differ only in the products' sum order.

Here, without a card, the wrapper runs the plain version for CPU tensors and
refuses every other device; the kernel itself is held against the plain
version on the card by tests/test_torch_port_gpu.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.ops.pallas.gru import pallas_gru_layer
from vae_gan_mark_tpu.ops.rnn import BiGRU as JaxBiGRU
from vae_gan_mark_tpu.ops.rnn import GRULayer as JaxGRULayer
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.ops.rnn import BiGRU, GRULayer, input_projection

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LENGTH = 60


def gru_params(rng, in_dim, hidden):
    bound = 1.0 / np.sqrt(hidden)
    u = lambda *shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    return {"w_ih": u(in_dim, 3 * hidden), "b_ih": u(3 * hidden),
            "w_hh": u(hidden, 3 * hidden), "b_hh": u(3 * hidden)}


def load_direction(module, suffix, p):
    with torch.no_grad():
        getattr(module, f"weight_ih_{suffix}").copy_(torch.from_numpy(p["w_ih"].T))
        getattr(module, f"bias_ih_{suffix}").copy_(torch.from_numpy(p["b_ih"]))
        getattr(module, f"weight_hh_{suffix}").copy_(torch.from_numpy(p["w_hh"].T))
        getattr(module, f"bias_hh_{suffix}").copy_(torch.from_numpy(p["b_hh"]))


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_matches_pallas_kernel(hidden, reverse):
    rng = np.random.default_rng(hidden)
    batch = 3
    x_proj = rng.normal(0, 1, (LENGTH, batch, 3 * hidden)).astype(np.float32)
    p = gru_params(rng, 1, hidden)
    xp = jnp.flip(jnp.asarray(x_proj), 0) if reverse else jnp.asarray(x_proj)
    ref = pallas_gru_layer(xp, p["w_hh"], p["b_hh"], True)
    ref = np.asarray(jnp.flip(ref, 0) if reverse else ref)
    got = gru.gru_recurrence(torch.from_numpy(x_proj),
                             torch.from_numpy(p["w_hh"].T.copy()),
                             torch.from_numpy(p["b_hh"]), reverse)
    assert got.shape == (LENGTH, batch, hidden) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "scan"])
def test_layer_matches_jax(hidden, reverse, use_pallas):
    rng = np.random.default_rng(10 + hidden)
    batch, in_dim = 2, 24
    x = rng.normal(0, 1, (batch, LENGTH, in_dim)).astype(np.float32)
    p = gru_params(rng, in_dim, hidden)
    ref = JaxGRULayer(hidden, reverse=reverse, use_pallas=use_pallas,
                      pallas_interpret=use_pallas).apply({"params": p}, x)
    layer = GRULayer(in_dim, hidden, reverse=reverse)
    load_direction(layer, "l0", p)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 256])
def test_bigru_matches_jax(hidden):
    rng = np.random.default_rng(20 + hidden)
    batch, in_dim, layers = 2, 32, 2
    x = rng.normal(0, 1, (batch, LENGTH, in_dim)).astype(np.float32)
    tree = {}
    port = BiGRU(in_dim, hidden, num_layers=layers, dropout=0.1).eval()
    for layer in range(layers):
        layer_in = in_dim if layer == 0 else 2 * hidden
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = gru_params(rng, layer_in, hidden)
            tree[f"l{layer}_{direction}"] = p
            load_direction(port, f"l{layer}{suffix}", p)
    ref = JaxBiGRU(hidden, num_layers=layers, dropout=0.1,
                   train=False).apply({"params": tree}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (batch, LENGTH, 2 * hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 256])
def test_bidirectional_forward_matches_jax_bigru(hidden):
    """``gru_bidirectional_forward`` equals two ``gru_recurrence`` calls
    (left to right, right to left), and a 2-layer BiGRU made of it and the
    input projections of ``ops/rnn.py`` matches JAX ``BiGRU``; inputs and
    weights as in ``test_bigru_matches_jax``."""
    rng = np.random.default_rng(20 + hidden)
    batch, in_dim, layers = 2, 32, 2
    x = rng.normal(0, 1, (batch, LENGTH, in_dim)).astype(np.float32)
    tree = {}
    for layer in range(layers):
        layer_in = in_dim if layer == 0 else 2 * hidden
        for direction in ("fwd", "bwd"):
            tree[f"l{layer}_{direction}"] = gru_params(rng, layer_in, hidden)
    ref = JaxBiGRU(hidden, num_layers=layers, dropout=0.1,
                   train=False).apply({"params": tree}, x)
    y = torch.from_numpy(x).transpose(0, 1)
    for layer in range(layers):
        dirs = []
        for direction in ("fwd", "bwd"):
            p = {k: torch.from_numpy(v.T.copy())
                 for k, v in tree[f"l{layer}_{direction}"].items()}
            dirs.append((input_projection(y, p["w_ih"], p["b_ih"]),
                         p["w_hh"], p["b_hh"]))
        pair = gru.gru_bidirectional_forward(*dirs)
        for d, reverse, got in zip(dirs, (False, True), pair):
            assert torch.equal(got, gru.gru_recurrence(*d, reverse))
        y = torch.cat(pair, dim=-1)
    np.testing.assert_allclose(y.transpose(0, 1).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_matches_pallas_vjp(hidden, reverse):
    """dx_proj, dW_hh, db_hh of the plain backward against ``jax.vjp`` of
    ``pallas_gru_layer`` (interpret mode), whose backward is ``_bwd``."""
    rng = np.random.default_rng(30 + hidden)
    batch = 3
    x_proj = rng.normal(0, 1, (LENGTH, batch, 3 * hidden)).astype(np.float32)
    p = gru_params(rng, 1, hidden)
    cot = rng.normal(0, 1, (LENGTH, batch, hidden)).astype(np.float32)

    def layer(xp, w, b):
        if reverse:
            return jnp.flip(pallas_gru_layer(jnp.flip(xp, 0), w, b, True), 0)
        return pallas_gru_layer(xp, w, b, True)

    outs, vjp = jax.vjp(layer, jnp.asarray(x_proj), jnp.asarray(p["w_hh"]),
                        jnp.asarray(p["b_hh"]))
    ref_dx, ref_dw, ref_db = vjp(jnp.asarray(cot))
    dx, dw, db = gru.gru_recurrence_backward(
        torch.from_numpy(x_proj), torch.from_numpy(p["w_hh"].T.copy()),
        torch.from_numpy(p["b_hh"]), torch.from_numpy(np.array(outs)),
        torch.from_numpy(cot), reverse)
    tol = dict(rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw).T, **tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), **tol)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "scan"])
def test_layer_gradients_match_jax(hidden, reverse, use_pallas):
    """Every gradient of a single-direction layer (input, W_ih, b_ih, W_hh,
    b_hh) through the autograd function, against ``jax.vjp`` of JAX
    ``GRULayer`` on its Pallas (custom_vjp) and scan (autodiff) paths."""
    rng = np.random.default_rng(40 + hidden)
    batch, in_dim = 2, 24
    x = rng.normal(0, 1, (batch, LENGTH, in_dim)).astype(np.float32)
    p = gru_params(rng, in_dim, hidden)
    cot = rng.normal(0, 1, (batch, LENGTH, hidden)).astype(np.float32)
    jax_layer = JaxGRULayer(hidden, reverse=reverse, use_pallas=use_pallas,
                            pallas_interpret=use_pallas)
    _, vjp = jax.vjp(lambda params, x_: jax_layer.apply({"params": params},
                                                       x_), p, x)
    ref_p, ref_x = vjp(jnp.asarray(cot))
    layer = GRULayer(in_dim, hidden, reverse=reverse)
    load_direction(layer, "l0", p)
    xt = torch.from_numpy(x).requires_grad_()
    layer(xt).backward(torch.from_numpy(cot))
    tol = dict(rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), **tol)
    for name, jname, transpose in (("weight_ih_l0", "w_ih", True),
                                   ("bias_ih_l0", "b_ih", False),
                                   ("weight_hh_l0", "w_hh", True),
                                   ("bias_hh_l0", "b_hh", False)):
        ref = np.asarray(ref_p[jname])
        np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                   ref.T if transpose else ref,
                                   err_msg=name, **tol)


@pytest.mark.parametrize("hidden", [16, 256])
def test_bigru_gradients_match_jax(hidden):
    """Every gradient of a 2-layer BiGRU in eval mode (input and all 16
    parameters) through the bidirectional autograd function, against
    ``jax.vjp`` of JAX ``BiGRU(train=False)``."""
    rng = np.random.default_rng(50 + hidden)
    batch, in_dim, layers = 2, 24, 2
    x = rng.normal(0, 1, (batch, LENGTH, in_dim)).astype(np.float32)
    cot = rng.normal(0, 1, (batch, LENGTH, 2 * hidden)).astype(np.float32)
    tree, names = {}, []
    port = BiGRU(in_dim, hidden, num_layers=layers, dropout=0.1).eval()
    for layer in range(layers):
        layer_in = in_dim if layer == 0 else 2 * hidden
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = gru_params(rng, layer_in, hidden)
            tree[f"l{layer}_{direction}"] = p
            load_direction(port, f"l{layer}{suffix}", p)
            names.append((f"l{layer}_{direction}", f"l{layer}{suffix}"))
    jax_bigru = JaxBiGRU(hidden, num_layers=layers, dropout=0.1, train=False)
    _, vjp = jax.vjp(lambda params, x_: jax_bigru.apply({"params": params},
                                                       x_), tree, x)
    ref_p, ref_x = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    port(xt).backward(torch.from_numpy(cot))
    tol = dict(rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), **tol)
    for jax_name, suffix in names:
        for name, jname, transpose in (("weight_ih", "w_ih", True),
                                       ("bias_ih", "b_ih", False),
                                       ("weight_hh", "w_hh", True),
                                       ("bias_hh", "b_hh", False)):
            ref = np.asarray(ref_p[jax_name][jname])
            np.testing.assert_allclose(
                getattr(port, f"{name}_{suffix}").grad.numpy(),
                ref.T if transpose else ref, err_msg=f"{name}_{suffix}",
                **tol)


def test_bigru_dropout_draws_from_the_generator():
    """Train-mode dropout between layers comes from the given generator:
    the same seed gives the same output, another seed another one, and no
    generator is an error. Eval mode ignores it."""
    port = BiGRU(8, 16, num_layers=2, dropout=0.5).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 12, 8)).astype(np.float32))
    with torch.no_grad():
        a = port(x, torch.Generator().manual_seed(1))
        b = port(x, torch.Generator().manual_seed(1))
        c = port(x, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="torch.Generator"):
            port(x)
        port.eval()
        assert torch.equal(port(x), port(x, torch.Generator().manual_seed(3)))


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.zeros(4, 2, 48, device="meta")
    w = torch.zeros(48, 16, device="meta")
    b = torch.zeros(48, device="meta")
    with pytest.raises(RuntimeError, match="no GRU kernel"):
        gru.gru_recurrence(x, w, b)


def test_cuda_request_raises_without_a_card(monkeypatch):
    """A CUDA request goes to the kernel and never to the plain version.

    Fake CUDA tensors (shape, dtype and device, no storage) reach the
    wrapper without a card: a recording kernel shows the dispatch, and the
    real kernel, which cannot be built or launched here, raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA request")

    calls = []

    def recording_kernel(directions):
        calls.append([(x_proj.device.type, w_hh.device.type,
                       b_hh.device.type, reverse)
                      for x_proj, w_hh, b_hh, reverse in directions])
        raise RuntimeError("recording kernel")

    real_kernel = gru.KERNEL
    monkeypatch.setattr(gru, "gru_recurrence_plain", plain)
    with FakeTensorMode():
        x = torch.empty(4, 2, 48, device="cuda")
        w = torch.empty(48, 16, device="cuda")
        b = torch.empty(48, device="cuda")
        monkeypatch.setattr(gru, "KERNEL", recording_kernel)
        for reverse in (False, True):
            with pytest.raises(RuntimeError, match="recording kernel"):
                gru.gru_recurrence(x, w, b, reverse)
        assert calls == [[("cuda", "cuda", "cuda", False)],
                         [("cuda", "cuda", "cuda", True)]]
        if not torch.cuda.is_available():
            monkeypatch.setattr(gru, "KERNEL", real_kernel)
            launches = real_kernel.launches
            with pytest.raises(RuntimeError):
                gru.gru_recurrence(x, w, b)
            assert real_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gru.KERNEL([(torch.zeros(4, 2, 48), torch.zeros(48, 16),
                     torch.zeros(48), False)])


def test_cuda_backward_reaches_the_kernel(monkeypatch):
    """The backward of a CUDA request goes to the backward kernel (after
    the gate pre-activations' product), never to the plain version; the
    real kernel cannot be built or launched here and raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args):
        raise AssertionError("the plain backward ran for a CUDA request")

    calls = []

    def recording_kernel(directions):
        for x_proj, hp_outs, outs, grad, w_hh, b_hh, reverse in directions:
            calls.append((tuple(hp_outs.shape), tuple(outs.shape),
                          hp_outs.device.type, reverse))
        raise RuntimeError("recording kernel")

    real_kernel = gru.BACKWARD_KERNEL
    monkeypatch.setattr(gru, "gru_backward_plain", plain)
    with FakeTensorMode():
        x = torch.empty(4, 2, 48, device="cuda")
        w = torch.empty(48, 16, device="cuda")
        b = torch.empty(48, device="cuda")
        outs = torch.empty(4, 2, 16, device="cuda")
        g = torch.empty(4, 2, 16, device="cuda")
        monkeypatch.setattr(gru, "BACKWARD_KERNEL", recording_kernel)
        for reverse in (False, True):
            with pytest.raises(RuntimeError, match="recording kernel"):
                gru.gru_recurrence_backward(x, w, b, outs, g, reverse)
        assert calls == [((4, 2, 48), (4, 2, 16), "cuda", False),
                         ((4, 2, 48), (4, 2, 16), "cuda", True)]
        if not torch.cuda.is_available():
            monkeypatch.setattr(gru, "BACKWARD_KERNEL", real_kernel)
            launches = real_kernel.launches
            with pytest.raises(RuntimeError):
                gru.gru_recurrence_backward(x, w, b, outs, g)
            assert real_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        z = torch.zeros(4, 2, 48)
        gru.BACKWARD_KERNEL([(z, z, torch.zeros(4, 2, 16),
                              torch.zeros(4, 2, 16), torch.zeros(48, 16),
                              torch.zeros(48), False)])


class _Ctx:
    """Stands in for autograd's context object when an autograd function's
    forward and backward are called directly (autograd itself cannot run
    on fake CUDA tensors in a CPU-only build)."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def test_bigru_backward_reaches_the_kernel_once_per_layer(monkeypatch):
    """A 2-layer BiGRU on (fake) CUDA tensors: each layer's backward is one
    backward kernel call holding both directions (forward left to right,
    backward right to left), and the plain backward never runs. The
    recording kernel stops each backward after its call: the dW_hh products
    that follow cannot run on fake CUDA tensors in a CPU-only build."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from vae_gan_mark_tpu_torch.ops import rnn

    def plain(*args):
        raise AssertionError("the plain backward ran for a CUDA request")

    def forward_kernel(directions):
        return [x_proj.new_empty(x_proj.shape[:2] + (w_hh.shape[1],))
                for x_proj, w_hh, _, _ in directions]

    calls, contexts = [], []

    def recording_kernel(directions):
        calls.append([(d[0].device.type, tuple(d[2].shape), d[6])
                      for d in directions])
        raise RuntimeError("recording kernel")

    def traced_layer(*args):
        ctx = _Ctx()
        contexts.append(ctx)
        return gru.BiGRURecurrence.forward(ctx, *args)

    monkeypatch.setattr(gru, "gru_backward_plain", plain)
    monkeypatch.setattr(gru, "KERNEL", forward_kernel)
    monkeypatch.setattr(gru, "BACKWARD_KERNEL", recording_kernel)
    monkeypatch.setattr(rnn, "bigru_recurrence_grad", traced_layer)
    hidden, length, batch = 16, 6, 2
    port = BiGRU(8, hidden, num_layers=2, dropout=0.0)
    with FakeTensorMode(), torch.no_grad():
        for name, param in list(port.named_parameters()):
            setattr(port, name, torch.nn.Parameter(
                torch.empty(param.shape, device="cuda"), requires_grad=False))
        y = port(torch.empty(batch, length, 8, device="cuda"))
        assert tuple(y.shape) == (batch, length, 2 * hidden)
        g = torch.empty(length, batch, hidden, device="cuda")
        for ctx in contexts:
            with pytest.raises(RuntimeError, match="recording kernel"):
                gru.BiGRURecurrence.backward(ctx, g, g)
    assert calls == [[("cuda", (length, batch, hidden), False),
                      ("cuda", (length, batch, hidden), True)]] * 2


def test_bigru_forward_reaches_the_kernel_once_per_layer(monkeypatch):
    """A 2-layer BiGRU on (fake) CUDA tensors: each layer's forward is one
    forward kernel call holding both directions (left to right, then right
    to left), and the plain forward never runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from vae_gan_mark_tpu_torch.ops import rnn

    def plain(*args):
        raise AssertionError("the plain forward ran for a CUDA request")

    calls = []

    def recording_kernel(directions):
        calls.append([(x.device.type, tuple(x.shape), reverse)
                      for x, _, _, reverse in directions])
        return [x.new_empty(x.shape[:2] + (w.shape[1],))
                for x, w, _, _ in directions]

    monkeypatch.setattr(gru, "gru_recurrence_plain", plain)
    monkeypatch.setattr(gru, "KERNEL", recording_kernel)
    monkeypatch.setattr(rnn, "bigru_recurrence_grad",
                        lambda *args: gru.BiGRURecurrence.forward(_Ctx(),
                                                                  *args))
    hidden, length, batch = 16, 6, 2
    port = BiGRU(8, hidden, num_layers=2, dropout=0.0)
    with FakeTensorMode(), torch.no_grad():
        for name, param in list(port.named_parameters()):
            setattr(port, name, torch.nn.Parameter(
                torch.empty(param.shape, device="cuda"), requires_grad=False))
        y = port(torch.empty(batch, length, 8, device="cuda"))
        assert tuple(y.shape) == (batch, length, 2 * hidden)
        assert y.device.type == "cuda"
    x_shape = (length, batch, 3 * hidden)
    assert calls == [[("cuda", x_shape, False), ("cuda", x_shape, True)]] * 2


@pytest.mark.parametrize("bad,error", [("shape", ValueError),
                                       ("device", ValueError),
                                       ("meta", RuntimeError)])
def test_bidirectional_forward_refuses_bad_pairs(bad, error):
    """The two directions must share device and shape, and a device
    without a kernel is refused."""
    def direction(length=4, device="cpu"):
        return (torch.zeros(length, 2, 48, device=device),
                torch.zeros(48, 16, device=device),
                torch.zeros(48, device=device))

    pairs = {"shape": (direction(), direction(length=5)),
             "device": (direction(), direction(device="meta")),
             "meta": (direction(device="meta"), direction(device="meta"))}
    with pytest.raises(error):
        gru.gru_bidirectional_forward(*pairs[bad])


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_wrapper_validates_inputs(bad):
    x, w, b = torch.zeros(4, 2, 48), torch.zeros(48, 16), torch.zeros(48)
    if bad == "shape":
        w = torch.zeros(16, 48)
    elif bad == "dtype":
        x = x.double()
    else:
        b = b.to("meta")
    with pytest.raises((ValueError, TypeError)):
        gru.gru_recurrence(x, w, b)
