"""The yardstick: the card's published peaks, the least time of a count of
operations, and the work of the GRU kernels counted from their shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
outside them (TF32 off), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: dict) -> float:
    """Sum over precisions of the operations at that precision's peak."""
    return sum(n / PEAK_FLOPS[p] for p, n in flops.items())


def bound_seconds(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def gru_forward_launch(length: int, batch: int, hidden: int,
                       directions: int = 2) -> float:
    """Least time of one ``gru_fwd_kernel`` launch: both directions of a
    BiGRU layer. Per direction the recurrence h @ W_hh^T over L steps,
    2 L B H 3H flops in float32; bytes: x_proj (L, B, 3H) read, outputs
    (L, B, H) written, W_hh and b_hh read."""
    flops = 2 * length * batch * hidden * 3 * hidden
    nbytes = 4 * (length * batch * 3 * hidden + length * batch * hidden
                  + 3 * hidden * hidden + 3 * hidden)
    return bound_seconds(directions * flops, directions * nbytes,
                         PEAK_FLOPS["f32"])


def gru_backward_launch(length: int, batch: int, hidden: int,
                        directions: int = 2) -> float:
    """Least time of one ``gru_bwd_kernel`` launch: both directions of a
    layer. Per direction the dh recurrence dhp @ W_hh over L steps,
    2 L B 3H H flops (the gate pre-activations and dW_hh are products
    outside the kernel); bytes: x_proj and hp (L, B, 3H), outputs and
    their cotangent (L, B, H), W_hh and b_hh read, dx_proj and dhp
    (L, B, 3H) written."""
    flops = 2 * length * batch * 3 * hidden * hidden
    nbytes = 4 * (4 * length * batch * 3 * hidden + 2 * length * batch
                  * hidden + 3 * hidden * hidden + 3 * hidden)
    return bound_seconds(directions * flops, directions * nbytes,
                         PEAK_FLOPS["f32"])
