"""The conv probe: a SAME, stride-1 3x3 convolution in NHWC as a
hand-written Hopper kernel, the port of
``benchmarks/pallas_conv_probe.py:conv3x3_superp``.

``conv3x3_superp(x, k, f)`` takes x (N, H, W, C) and k (3, 3, C, C) in the
probe's HWIO layout, casts k to x's dtype and returns (N, H, W, C) in x's
dtype, with float32 accumulation. It keeps the probe's checks (C_out ==
C_in, W % f == 0, H % 8 == 0); the width fold ``f`` is a TPU lane trick that
does not change the result, so the kernel ignores it.

* A tensor on the CPU goes to ``conv3x3_plain``: ``F.conv2d`` on the
  permuted tensors, in float32 on the bf16-rounded operands.
* A CUDA tensor goes to the kernel in ``csrc/conv3x3.cu`` (bf16, C in
  ``KERNEL_CHANNELS``: the probe's two widths) or raises. The kernel is a
  tensor-core implicit GEMM (wgmma, TMA-fed halo tiles); the wrapper hands
  it k as [dy][dx][C_out][C_in]. Each launch adds one to
  ``KERNEL.launches``.

No model calls it: the JAX package runs its probe beside the models, never
on a path, and so does the port. ``PROBE_SHAPES`` are the probe's two
benchmark cases, (N, H, W, C, f).

Importing this module builds nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vae_gan_mark_tpu_torch.ops.cuda_build import INT, PTR, CudaKernel

SH = 8   # the probe's strip height: H must be a multiple of it
KERNEL_CHANNELS = (32, 64)   # the C the kernel is built for

PROBE_SHAPES = {
    "v2_full_res_64ch_f2": (128, 64, 448, 64, 2),
    "oldv_full_res_32ch_f4": (64, 64, 448, 32, 4),
}


class CudaConv3x3(CudaKernel):
    """The kernel, ``csrc/conv3x3.cu``."""

    def __init__(self):
        super().__init__("conv3x3.cu",
                         {"conv3x3_forward": [PTR] * 3 + [INT] * 4 + [PTR]},
                         "conv3x3_error_string")

    def __call__(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"the conv3x3 kernel takes CUDA tensors, got "
                             f"{x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the conv3x3 kernel takes bfloat16, got "
                            f"{x.dtype}")
        n, h, w, c = x.shape
        if c not in KERNEL_CHANNELS:
            raise ValueError(f"the conv3x3 kernel takes C in "
                             f"{KERNEL_CHANNELS}, got C={c}")
        self.load()
        y = torch.empty_like(x)
        k_nk = k.permute(0, 1, 3, 2).contiguous()   # each tap (C_out, C_in)
        with torch.cuda.device(x.device):
            self.launch("conv3x3_forward", x.data_ptr(), k_nk.data_ptr(),
                        y.data_ptr(), n, h, w, c,
                        torch.cuda.current_stream(x.device).cuda_stream,
                        what=f"N={n}, H={h}, W={w}, C={c}")
        return y


KERNEL = CudaConv3x3()


def _check(x: torch.Tensor, k: torch.Tensor, f: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if tuple(k.shape) != (3, 3, c, c):
        raise ValueError(f"k must be (3, 3, C, C) with C_out == C_in == {c}, "
                         f"got {tuple(k.shape)}")
    if f < 1 or w % f or h % SH:
        raise ValueError(f"the probe needs W % f == 0 and H % {SH} == 0, got "
                         f"H={h}, W={w}, f={f}")
    if k.device != x.device:
        raise ValueError(f"k is on {k.device}, x on {x.device}")


def conv3x3_superp(x: torch.Tensor, k: torch.Tensor,
                   f: int = 2) -> torch.Tensor:
    """SAME stride-1 3x3 conv, NHWC, k (3, 3, C, C) cast to x's dtype."""
    _check(x, k, f)
    k = k.to(x.dtype)
    if x.device.type == "cpu":
        return conv3x3_plain(x, k)
    if x.device.type != "cuda":
        raise RuntimeError(f"no conv3x3 kernel for device {x.device}")
    return KERNEL(x.contiguous(), k.contiguous())


def conv3x3_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The kernel's function: float32 accumulation over x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 k.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
