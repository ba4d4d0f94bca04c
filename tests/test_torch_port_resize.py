"""The port's bilinear resize without a card: CPU tensors take
``F.interpolate`` exactly as before and launch nothing; a CUDA tensor goes
to the custom op and from there to the kernels of
``csrc/resize_bilinear.cu`` and never to ``F.interpolate``; the ops'
registrations (CPU, CUDA, fake, autograd) pass ``torch.library.opcheck``
on CPU tensors. The kernels themselves are held against ``F.interpolate``
on the card by tests/test_torch_port_gpu.py and ``chip_smoke.py``.
"""

import pytest
import torch
import torch.nn.functional as F

import torch_port_common  # noqa: F401  (two torch threads a worker)
from vae_gan_mark_tpu_torch.ops import cuda_build, resize

SHAPES = [((2, 3, 1, 7), (1, 28)), ((2, 3, 4, 7), (4, 28)),
          ((2, 3, 4, 7), (1, 14)), ((2, 3, 1, 7), (8, 14)),
          ((2, 3, 6, 10), (3, 4))]


LAYOUTS = ["nchw", "permuted", "channels_last"]


def _input(shape, layout, dtype=torch.float32):
    """NCHW memory, a permuted view of (N, W, H, C) memory, or channels-last
    memory (N, H, W, C)."""
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(0)
    if layout == "permuted":
        x = torch.randn(n, w, h, c, generator=gen).permute(0, 3, 2, 1)
    elif layout == "channels_last":
        x = torch.randn(n, h, w, c, generator=gen).permute(0, 3, 1, 2)
    else:
        x = torch.randn(shape, generator=gen)
    return x.to(dtype)


def _launches():
    return (resize.RESIZE_KERNEL.launches,
            resize.RESIZE_BACKWARD_KERNEL.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,out", SHAPES)
def test_cpu_resize_is_f_interpolate(monkeypatch, shape, out, layout, dtype):
    """On the CPU the output and the input gradient are F.interpolate's in
    float32, bit for bit, cast back to the input's dtype; no op is called
    and no kernel launched."""
    def no_op(*args):
        raise AssertionError("a CPU tensor reached the resize op")

    monkeypatch.setattr(resize, "resize_bilinear_op", no_op)
    x = _input(shape, layout, dtype).requires_grad_()
    before = _launches()
    got = resize.interpolate_bilinear(x, *out)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (got.float() * grad).sum().backward()
    x_ref = x.detach().clone().requires_grad_()
    want = F.interpolate(x_ref.float(), size=out, mode="bilinear",
                         align_corners=False).to(dtype)
    (want.float() * grad).sum().backward()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(x.grad, x_ref.grad)
    assert _launches() == before


def test_same_shape_returns_the_input():
    x = torch.randn(2, 3, 1, 7)
    assert resize.interpolate_bilinear(x, 1, 7) is x


def test_cuda_request_goes_to_the_op_not_to_f_interpolate(monkeypatch):
    """A (fake) CUDA tensor of any dtype goes to ``resize_bilinear_op`` in
    float32, whose output is cast back; F.interpolate is never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_interpolate(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached F.interpolate")

    calls = []

    def recording_op(x, out_h, out_w):
        calls.append((x.device.type, x.dtype, tuple(x.shape), out_h, out_w))
        return x.new_empty(x.shape[:2] + (out_h, out_w))

    monkeypatch.setattr(F, "interpolate", no_interpolate)
    monkeypatch.setattr(resize, "resize_bilinear_op", recording_op)
    with FakeTensorMode():
        x = torch.empty(2, 3, 4, 7, device="cuda", dtype=torch.bfloat16)
        y = resize.interpolate_bilinear(x, 1, 14)
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 3, 1, 14)
    assert calls == [("cuda", torch.float32, (2, 3, 4, 7), 1, 14)]


def test_cuda_tensors_reach_the_kernels(monkeypatch):
    """The ops' implementations send (fake) CUDA tensors to the forward
    kernel with the input's strides untouched and to the backward kernel,
    never to the plain versions; the real kernels cannot be built or
    launched here and raise, counting no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    calls = []

    def forward_kernel(x, out_h, out_w):
        calls.append(("forward", x.device.type, x.stride(), out_h, out_w))
        raise RuntimeError("recording kernel")

    def backward_kernel(grad, in_h, in_w):
        calls.append(("backward", grad.device.type, grad.stride(), in_h,
                      in_w))
        raise RuntimeError("recording kernel")

    real = resize.RESIZE_KERNEL, resize.RESIZE_BACKWARD_KERNEL
    monkeypatch.setattr(F, "interpolate", no_plain)
    monkeypatch.setattr(torch.ops.aten, "upsample_bilinear2d_backward",
                        no_plain)
    with FakeTensorMode():
        x = torch.empty(2, 7, 1, 3, device="cuda").permute(0, 3, 2, 1)
        grad = torch.empty(2, 3, 1, 28, device="cuda")
        monkeypatch.setattr(resize, "RESIZE_KERNEL", forward_kernel)
        monkeypatch.setattr(resize, "RESIZE_BACKWARD_KERNEL",
                            backward_kernel)
        with pytest.raises(RuntimeError, match="recording kernel"):
            resize.resize_bilinear(x, 1, 28)
        with pytest.raises(RuntimeError, match="recording kernel"):
            resize.resize_bilinear_backward(grad, 1, 7)
        assert calls == [("forward", "cuda", (21, 1, 3, 3), 1, 28),
                         ("backward", "cuda", (84, 28, 28, 1), 1, 7)]
        if not torch.cuda.is_available():
            monkeypatch.setattr(resize, "RESIZE_KERNEL", real[0])
            monkeypatch.setattr(resize, "RESIZE_BACKWARD_KERNEL", real[1])
            before = _launches()
            with pytest.raises(RuntimeError):
                resize.resize_bilinear(x, 1, 28)
            with pytest.raises(RuntimeError):
                resize.resize_bilinear_backward(grad, 1, 7)
            assert _launches() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        real[0](torch.zeros(2, 3, 1, 7), 1, 28)
    with pytest.raises(ValueError, match="CUDA tensors"):
        real[1](torch.zeros(2, 3, 1, 28), 1, 7)


def test_the_ops_have_cpu_cuda_and_fake_implementations():
    for name in ("resize_bilinear", "resize_bilinear_backward"):
        qualified = f"{resize.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                qualified, key), (qualified, key)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,out", SHAPES)
def test_ops_pass_opcheck_on_cpu(shape, out, layout):
    """Schema, fake implementation and autograd registration of both ops on
    CPU tensors; the forward op's output and gradient are F.interpolate's
    bit for bit, in its memory format."""
    x = _input(shape, layout).requires_grad_()
    torch.library.opcheck(resize.resize_bilinear_op, (x, *out))
    grad = torch.randn((shape[0], shape[1]) + out)
    torch.library.opcheck(resize.resize_bilinear_backward_op,
                          (grad, *shape[2:]))
    y = resize.resize_bilinear_op(x, *out)
    y.backward(grad)
    x_ref = x.detach().clone().requires_grad_()
    want = F.interpolate(x_ref, size=out, mode="bilinear",
                         align_corners=False)
    want.backward(grad)
    assert y.stride() == want.stride() and torch.equal(y, want)
    assert torch.equal(x.grad, x_ref.grad)


def test_fake_ops_give_shapes_and_refuse_what_the_kernels_do_not_take():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(16, 28, 512, device="cuda").transpose(
            1, 2).unsqueeze(2)
        y = resize.resize_bilinear_op(x, 1, 448)
        assert tuple(y.shape) == (16, 512, 1, 448)
        assert y.is_contiguous(memory_format=torch.channels_last)
        nchw = resize.resize_bilinear_op(
            torch.empty(16, 512, 1, 28, device="cuda"), 1, 448)
        assert nchw.is_contiguous()
        assert y.device.type == "cuda" and y.dtype == torch.float32
        dx = resize.resize_bilinear_backward_op(y, 1, 28)
        assert tuple(dx.shape) == (16, 512, 1, 28)
        with pytest.raises(TypeError, match="float32"):
            resize.resize_bilinear_op(x.bfloat16(), 1, 448)
        with pytest.raises(ValueError, match="NCHW"):
            resize.resize_bilinear_op(x.squeeze(2), 1, 448)
        with pytest.raises(ValueError, match="positive"):
            resize.resize_bilinear_op(x, 0, 448)


def test_build_all_compiles_a_source_named_twice_once(monkeypatch, tmp_path):
    """The forward and backward kernel objects share one library: a build of
    both starts one compiler."""
    started = []

    class FakeCompiler:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            with open(self.out, "w"):
                pass
            return "", None

        def poll(self):
            return 0

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeCompiler)
    kernels = (resize.RESIZE_KERNEL, resize.RESIZE_BACKWARD_KERNEL)
    assert kernels[0].source == kernels[1].source
    built = cuda_build.build_all([k.source for k in kernels])
    assert len(started) == 1 and list(built) == [kernels[0].source]
    assert built[kernels[0].source][0].exists()
