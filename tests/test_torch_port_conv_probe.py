"""The port of the conv probe against the JAX package's: the plain version
against ``benchmarks/pallas_conv_probe.py:conv3x3_superp`` in interpret
mode, at the probe's own check shape (2, 16, 32) for C=64, f=2 and C=32,
f=4, with the probe's rule: max |err| / max |ref| < 5e-2. Both sides take
bf16 in and out with float32 accumulation, so they differ only where the
float32 sums round to neighbouring bf16 values: the reading is 2.7e-5
(C=64) and 1.0e-4 (C=32), at fewer than 1e-4 of the outputs.

Here, without a card, the wrapper runs the plain version for CPU tensors and
refuses every other device; the kernel itself is held against the plain
version on the card by tests/test_torch_port_gpu.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.pallas_conv_probe import conv3x3_superp as jax_superp
from vae_gan_mark_tpu_torch.ops import conv_probe

PROBE_RULE = 5e-2


def probe_inputs(n, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    k = (rng.normal(0, 1, (3, 3, c, c)) / (3 * c ** 0.5)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("c,f", [(64, 2), (32, 4)])
def test_plain_matches_pallas_probe(c, f):
    x, k = probe_inputs(2, 16, 32, c)
    x_bf16 = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax_superp(x_bf16, jnp.asarray(k), f=f,
                                interpret=True).astype(jnp.float32))
    x_port = torch.from_numpy(np.array(x_bf16.astype(jnp.float32))
                              ).bfloat16()
    got = conv_probe.conv3x3_superp(x_port, torch.from_numpy(k), f)
    assert got.dtype == torch.bfloat16 and got.shape == x_port.shape
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < PROBE_RULE, err


def test_plain_is_a_same_conv():
    """Zero padding and HWIO taps: an impulse kernel shifts the image."""
    x = torch.arange(2 * 8 * 6 * 8, dtype=torch.float32).reshape(2, 8, 6, 8)
    k = torch.zeros(3, 3, 8, 8)
    k[0, 2] = torch.eye(8)                    # dy = -1, dx = +1
    y = conv_probe.conv3x3_superp(x, k, 2)
    assert torch.equal(y[:, 1:, :-1], x[:, :-1, 1:])
    assert torch.equal(y[:, 0], torch.zeros_like(y[:, 0]))
    assert torch.equal(y[:, :, -1], torch.zeros_like(y[:, :, -1]))


@pytest.mark.parametrize("shape,k_shape,f", [
    ((2, 16, 32, 64), (3, 3, 64, 32), 2),   # C_out != C_in
    ((2, 12, 32, 64), (3, 3, 64, 64), 2),   # H not a multiple of 8
    ((2, 16, 30, 64), (3, 3, 64, 64), 4),   # W not a multiple of f
])
def test_wrapper_keeps_the_probe_checks(shape, k_shape, f):
    with pytest.raises(ValueError):
        conv_probe.conv3x3_superp(torch.zeros(shape), torch.zeros(k_shape), f)


def test_probe_shapes_are_the_benchmarks():
    assert conv_probe.PROBE_SHAPES == {
        "v2_full_res_64ch_f2": (128, 64, 448, 64, 2),
        "oldv_full_res_32ch_f4": (64, 64, 448, 32, 4)}


def test_cuda_request_reaches_the_kernel(monkeypatch):
    """A CUDA request goes to the kernel and never to the plain version;
    the real kernel cannot be built or launched here and raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA request")

    calls = []

    def recording_kernel(x, k):
        calls.append((x.device.type, k.device.type, x.dtype, k.dtype))
        raise RuntimeError("recording kernel")

    real_kernel = conv_probe.KERNEL
    monkeypatch.setattr(conv_probe, "conv3x3_plain", plain)
    with FakeTensorMode():
        x = torch.empty(2, 16, 32, 64, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(3, 3, 64, 64, device="cuda")
        monkeypatch.setattr(conv_probe, "KERNEL", recording_kernel)
        with pytest.raises(RuntimeError, match="recording kernel"):
            conv_probe.conv3x3_superp(x, k, 2)
        assert calls == [("cuda", "cuda", torch.bfloat16, torch.bfloat16)]
        if not torch.cuda.is_available():
            monkeypatch.setattr(conv_probe, "KERNEL", real_kernel)
            launches = real_kernel.launches
            with pytest.raises(RuntimeError):
                conv_probe.conv3x3_superp(x, k, 2)
            assert real_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_probe.KERNEL(torch.zeros(2, 16, 32, 64, dtype=torch.bfloat16),
                          torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("c", [16, 48, 128])
def test_kernel_refuses_other_widths(c):
    """The kernel is built for the probe's two widths, C in {32, 64}: a CUDA
    request at any other C raises this error before anything is built (a
    build here would fail for want of nvcc) or launched. The plain version
    on the CPU takes any C."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = conv_probe.KERNEL.launches
    with FakeTensorMode():
        x = torch.empty(2, 16, 32, c, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(3, 3, c, c, device="cuda")
        with pytest.raises(ValueError, match=r"C in \(32, 64\)"):
            conv_probe.conv3x3_superp(x, k, 2)
    assert conv_probe.KERNEL.launches == launches
