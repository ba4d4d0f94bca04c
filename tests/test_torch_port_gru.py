"""The port's GRU against the JAX package's: the recurrence alone against
the Pallas kernel (interpret mode), single-direction layers against JAX
``GRULayer`` on both its Pallas and scan paths, and the stacked BiGRU.

Tolerance rtol 1e-5, atol 1e-6 (the Pallas kernel's own test): both sides
are float32 and differ only in the products' sum order.

Here, without a card, the wrapper runs the plain version for CPU tensors and
refuses every other device; the kernel itself is held against the plain
version on the card by tests/test_torch_port_gpu.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gan_mark_tpu.ops.pallas.gru import pallas_gru_layer
from vae_gan_mark_tpu.ops.rnn import BiGRU as JaxBiGRU
from vae_gan_mark_tpu.ops.rnn import GRULayer as JaxGRULayer
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.ops.rnn import BiGRU, GRULayer

RTOL, ATOL = 1e-5, 1e-6
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

    def recording_kernel(x_proj, w_hh, b_hh, reverse):
        calls.append((x_proj.device.type, w_hh.device.type,
                      b_hh.device.type, reverse))
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
        assert calls == [("cuda", "cuda", "cuda", False),
                         ("cuda", "cuda", "cuda", True)]
        if not torch.cuda.is_available():
            monkeypatch.setattr(gru, "KERNEL", real_kernel)
            launches = real_kernel.launches
            with pytest.raises(RuntimeError):
                gru.gru_recurrence(x, w, b)
            assert real_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gru.KERNEL(torch.zeros(4, 2, 48), torch.zeros(48, 16),
                   torch.zeros(48), False)


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
