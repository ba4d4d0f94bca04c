"""Bilinear resize, ``align_corners=False`` and no antialias (the JAX
package's ``jax.image.resize(method='linear', antialias=False)``), and its
input gradient.

``interpolate_bilinear(x, out_h, out_w)`` resizes an NCHW tensor in float32
and returns it in ``x``'s dtype and in the memory format ``F.interpolate``
gives (channels-last where ``x``'s strides are, as the serving engine's
batch-1 text map's are; the convolutions after it depend on that layout):

* at the same (h, w) it returns ``x``;
* a CPU tensor goes to ``F.interpolate``, the plain version;
* any other tensor goes to the custom op ``vgm_torch::resize_bilinear``. On
  a CUDA tensor its implementation launches the forward kernel of
  ``csrc/resize_bilinear.cu`` (``RESIZE_KERNEL``) and its gradient the
  kernel's deterministic gather backward (``RESIZE_BACKWARD_KERNEL``), or
  raises: nothing falls back to ``F.interpolate``. Each launch adds one to
  the kernel's ``launches``; a CUDA graph's replays add what it captured.

The two ops (``resize_bilinear_op``, ``resize_bilinear_backward_op``) are
``torch.library`` custom ops with fake implementations, so ``torch.export``
keeps the resize as one node and a CUDA graph captures the launches. They
take CPU tensors too, through the plain version and ATen's backward.

Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

from vae_gan_mark_tpu_torch.ops.cuda_build import INT, PTR, CudaKernel

I64 = ctypes.c_int64


class CudaResize(CudaKernel):
    """The forward kernel of ``csrc/resize_bilinear.cu``."""

    def __init__(self):
        super().__init__(
            "resize_bilinear.cu",
            {"upsample_bilinear_forward": [PTR, PTR] + [INT] * 6 + [I64] * 8
             + [PTR]},
            "upsample_bilinear_error_string")

    def __call__(self, x: torch.Tensor, out_h: int,
                 out_w: int) -> torch.Tensor:
        """x: a float32 CUDA tensor (N, C, H, W) of any strides; returns
        (N, C, out_h, out_w) in the memory format of ``_output``."""
        if x.device.type != "cuda":
            raise ValueError(f"the resize kernel takes CUDA tensors, got "
                             f"{x.device}")
        n, c, in_h, in_w = x.shape
        y = _output(x, out_h, out_w)
        with torch.cuda.device(x.device):
            self.launch("upsample_bilinear_forward", x.data_ptr(),
                        y.data_ptr(), n, c, in_h, in_w, out_h, out_w,
                        *x.stride(), *y.stride(),
                        torch.cuda.current_stream(x.device).cuda_stream,
                        what=f"{tuple(x.shape)} -> ({out_h}, {out_w})")
        return y


class CudaResizeBackward(CudaKernel):
    """The gather backward of ``csrc/resize_bilinear.cu``."""

    def __init__(self):
        super().__init__(
            "resize_bilinear.cu",
            {"upsample_bilinear_backward": [PTR, PTR] + [INT] * 6 + [PTR]},
            "upsample_bilinear_error_string")

    def __call__(self, grad: torch.Tensor, in_h: int,
                 in_w: int) -> torch.Tensor:
        """grad: a contiguous float32 CUDA tensor (N, C, out_h, out_w);
        returns the input gradient (N, C, in_h, in_w), contiguous."""
        if grad.device.type != "cuda":
            raise ValueError(f"the resize backward kernel takes CUDA "
                             f"tensors, got {grad.device}")
        n, c, out_h, out_w = grad.shape
        dx = torch.empty((n, c, in_h, in_w), dtype=torch.float32,
                         device=grad.device)
        with torch.cuda.device(grad.device):
            self.launch("upsample_bilinear_backward", grad.data_ptr(),
                        dx.data_ptr(), n, c, in_h, in_w, out_h, out_w,
                        torch.cuda.current_stream(grad.device).cuda_stream,
                        what=f"{tuple(grad.shape)} -> ({in_h}, {in_w})")
        return dx


def _output(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """An empty float32 (N, C, out_h, out_w) in the memory format that
    ``F.interpolate`` gives ``x``: channels-last where ``x``'s strides are,
    NCHW otherwise."""
    return torch.empty((x.shape[0], x.shape[1], out_h, out_w),
                       dtype=torch.float32, device=x.device,
                       memory_format=suggest_memory_format(x))


RESIZE_KERNEL = CudaResize()
RESIZE_BACKWARD_KERNEL = CudaResizeBackward()


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Resize an NCHW tensor spatially to (out_h, out_w), in float32."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    if x.device.type == "cpu":
        y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                          align_corners=False, antialias=False)
    else:
        y = resize_bilinear_op(x.float(), out_h, out_w)
    return y.to(x.dtype)


def _check(x: torch.Tensor, out_h: int, out_w: int, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} takes an NCHW tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"{what}: sizes must be positive, got "
                         f"({out_h}, {out_w})")


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, C, H, W) float32 -> (N, C, out_h, out_w) float32 in the memory
    format ``F.interpolate`` gives: the kernel for a CUDA tensor (any
    strides), the plain version for a CPU one."""
    _check(x, out_h, out_w, "resize_bilinear")
    if x.device.type == "cpu":
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=False, antialias=False)
    if x.device.type != "cuda":
        raise RuntimeError(f"no resize kernel for device {x.device}")
    return RESIZE_KERNEL(x, out_h, out_w)


def resize_bilinear_backward(grad: torch.Tensor, in_h: int,
                             in_w: int) -> torch.Tensor:
    """The input gradient of ``resize_bilinear`` to an (N, C, in_h, in_w)
    input from ``grad`` (N, C, out_h, out_w), float32: the gather kernel
    for a CUDA tensor, ATen's backward for a CPU one."""
    _check(grad, in_h, in_w, "resize_bilinear_backward")
    n, c, out_h, out_w = grad.shape
    if grad.device.type == "cpu":
        return torch.ops.aten.upsample_bilinear2d_backward(
            grad, [out_h, out_w], [n, c, in_h, in_w], False)
    if grad.device.type != "cuda":
        raise RuntimeError(f"no resize kernel for device {grad.device}")
    return RESIZE_BACKWARD_KERNEL(grad.contiguous(), in_h, in_w)


# ------------------------------------------------------------ custom ops
NAMESPACE = "vgm_torch"


@torch.library.custom_op(f"{NAMESPACE}::resize_bilinear", mutates_args=(),
                         device_types=("cpu", "cuda"))
def resize_bilinear_op(x: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    return resize_bilinear(x, out_h, out_w)


@torch.library.custom_op(f"{NAMESPACE}::resize_bilinear_backward",
                         mutates_args=(), device_types=("cpu", "cuda"))
def resize_bilinear_backward_op(grad: torch.Tensor, in_h: int,
                                in_w: int) -> torch.Tensor:
    return resize_bilinear_backward(grad, in_h, in_w)


@resize_bilinear_op.register_fake
def _(x, out_h, out_w):
    _check(x, out_h, out_w, "resize_bilinear")
    return _output(x, out_h, out_w)


@resize_bilinear_backward_op.register_fake
def _(grad, in_h, in_w):
    _check(grad, in_h, in_w, "resize_bilinear_backward")
    return grad.new_empty((grad.shape[0], grad.shape[1], in_h, in_w))


def _setup_context(ctx, inputs, output):
    x, _, _ = inputs
    ctx.in_hw = (x.shape[2], x.shape[3])


def _backward(ctx, grad):
    return resize_bilinear_backward_op(grad, *ctx.in_hw), None, None


resize_bilinear_op.register_autograd(_backward, setup_context=_setup_context)
