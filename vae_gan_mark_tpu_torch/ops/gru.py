"""GRU recurrence: the hand-written Hopper kernels for its forward and its
gradient, and their plain PyTorch versions.

``gru_recurrence(x_proj, w_hh, b_hh, reverse)`` maps time-major input
projections (L, B, 3H) = x @ W_ih^T + b_ih to every hidden state (L, B, H),
from h0 = 0, with torch's gate order (r, z, n) and ``b_hn`` inside
``r * (...)``. It is the port of the JAX package's Pallas kernel
(``ops/pallas/gru.py:pallas_gru_layer``); ``reverse`` runs right to left and
returns outputs in input order.

``gru_recurrence_backward(x_proj, w_hh, b_hh, outs, grad, reverse)`` is the
port of that kernel's ``custom_vjp`` backward (``_bwd``): from the forward's
outputs and their cotangent it returns ``(dx_proj, dW_hh, db_hh)``.
``gru_bidirectional_forward`` and ``gru_bidirectional_backward`` do the same
for the two directions of a bidirectional layer (forward left to right,
backward right to left), each in one kernel launch. ``GRURecurrence`` (one
direction) and ``BiGRURecurrence`` (both) join forward and backward as
``torch.autograd.Function``s; their saved tensors are what ``_fwd`` keeps
(x_proj, w_hh, b_hh, outs), per direction.

* A tensor on the CPU goes to the plain versions, Python loops over t.
* A CUDA tensor goes to the kernels in ``csrc/gru_fwd.cu`` and
  ``csrc/gru_bwd.cu`` (each one launch for one or both directions) or
  raises. They are compiled with ``nvcc`` at first use
  (``ops/cuda_build.py``); each launch adds one to ``KERNEL.launches``
  (forward) or ``BACKWARD_KERNEL.launches`` (backward); ``prepare`` does
  a first launch's host work ahead of a CUDA graph capture, and
  ``prepare_capture`` calls it for the kernels a configuration's step
  launches. Around the backward
  kernel two products per direction without a sequential dependence go to
  ``torch.matmul``: the gate pre-activations of every step, recomputed from
  the saved outputs before it, and dW_hh after it.

Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from vae_gan_mark_tpu_torch.ops.cuda_build import INT, PTR, CudaKernel


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaGRU(CudaKernel):
    """The forward kernel, ``csrc/gru_fwd.cu``: the recurrence for one
    direction or for both directions of a layer in one launch."""

    def __init__(self):
        super().__init__("gru_fwd.cu",
                         {"gru_forward": [PTR, PTR] + [INT] * 4 + [PTR],
                          "gru_forward_tile_rows": [INT] * 3 + [PTR],
                          "gru_forward_max_clusters": [INT, INT, PTR]},
                         "gru_error_string")

    def __call__(self, directions: Sequence[Tuple]) -> List[torch.Tensor]:
        """``directions``: one or two tuples (x_proj, w_hh, b_hh, reverse)
        of contiguous float32 CUDA tensors of one shape; returns the hidden
        states (L, B, H) per direction."""
        x_proj = directions[0][0]
        if x_proj.device.type != "cuda":
            raise ValueError(f"the GRU kernel takes CUDA tensors, got "
                             f"{x_proj.device}")
        length, batch, h3 = x_proj.shape
        hidden = h3 // 3
        self.claim(x_proj.device.index)
        self.load()
        outs, ptrs = [], []
        for x, w_hh, b_hh, _ in directions:
            out = torch.empty((length, batch, hidden), dtype=torch.float32,
                              device=x.device)
            outs.append(out)
            ptrs += [t.data_ptr() for t in (x, w_hh, b_hh, out)]
        reverse = [int(d[3]) for d in directions]
        with torch.cuda.device(x_proj.device):
            self.launch("gru_forward", (ctypes.c_void_p * len(ptrs))(*ptrs),
                        (ctypes.c_int * len(reverse))(*reverse),
                        len(directions), length, batch, hidden,
                        _stream(x_proj),
                        what=f"{len(directions)} directions, L={length}, "
                             f"B={batch}, H={hidden}")
        return outs

    def max_active_clusters(self, hidden: int, tile_rows: int) -> int:
        """``cudaOccupancyMaxActiveClusters`` of the kernel at ``hidden``
        with ``tile_rows`` (16 or 32) batch rows per cluster."""
        return self.query("gru_forward_max_clusters", hidden, tile_rows)

    def plan(self, directions: int, batch: int, hidden: int) -> dict:
        """How a launch of ``directions`` directions at ``batch`` runs: the
        batch rows per 8-CTA cluster (32 where 16-row tiles would need more
        clusters than the card holds at once), the clusters it needs, how
        many the card holds, and so the waves."""
        self.claim(torch.cuda.current_device())
        rows = self.query("gru_forward_tile_rows", directions, batch, hidden)
        clusters = directions * -(-batch // rows)
        fit = self.max_active_clusters(hidden, rows)
        return dict(tile_rows=rows, clusters=clusters,
                    max_active_clusters=fit, waves=-(-clusters // fit))

    def prepare(self, batch: int, hidden: int) -> None:
        """The host work of a first launch of both directions at ``batch``
        and ``hidden``, done now: the library's load, the shared-memory
        attribute and the occupancy query that picks the tile rows. A CUDA
        graph capture calls this first, so that a launch it records only
        launches."""
        self.plan(2, batch, hidden)


class CudaGRUBackward(CudaKernel):
    """The backward kernel, ``csrc/gru_bwd.cu``: the sequential part of the
    gradient, dx_proj and the W_hh-side cotangents dhp of every step, for
    one direction or for both directions of a layer in one launch."""

    def __init__(self):
        super().__init__("gru_bwd.cu",
                         {"gru_backward": [PTR, PTR] + [INT] * 4 + [PTR],
                          "gru_backward_max_clusters": [INT, PTR]},
                         "gru_bwd_error_string")

    def __call__(self, directions: Sequence[Tuple]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``directions``: one or two tuples (x_proj, hp_outs, outs, grad,
        w_hh, b_hh, reverse) of contiguous float32 CUDA tensors of one
        shape; returns (dx_proj, dhp) per direction."""
        x_proj = directions[0][0]
        if x_proj.device.type != "cuda":
            raise ValueError(f"the GRU backward kernel takes CUDA tensors, "
                             f"got {x_proj.device}")
        length, batch, h3 = x_proj.shape
        hidden = h3 // 3
        self.claim(x_proj.device.index)
        self.load()
        outputs, ptrs = [], []
        for x, hp_outs, outs, grad, w_hh, b_hh, _ in directions:
            dxp, dhp = torch.empty_like(x), torch.empty_like(x)
            outputs.append((dxp, dhp))
            ptrs += [t.data_ptr() for t in (x, hp_outs, outs, grad, w_hh,
                                            b_hh, dxp, dhp)]
        reverse = [int(d[6]) for d in directions]
        with torch.cuda.device(x_proj.device):
            self.launch("gru_backward", (ctypes.c_void_p * len(ptrs))(*ptrs),
                        (ctypes.c_int * len(reverse))(*reverse),
                        len(directions), length, batch, hidden,
                        _stream(x_proj),
                        what=f"{len(directions)} directions, L={length}, "
                             f"B={batch}, H={hidden}")
        return outputs

    def max_active_clusters(self, hidden: int) -> int:
        """``cudaOccupancyMaxActiveClusters`` of the kernel at ``hidden``:
        how many 8-CTA clusters the card holds at once. A launch needs one
        per (direction, 16-row batch tile); beyond that it runs in waves."""
        self.claim(torch.cuda.current_device())
        return self.query("gru_backward_max_clusters", hidden)

    def prepare(self, batch: int, hidden: int) -> None:
        """The host work of a first launch at ``hidden``, done now: the
        library's load and the shared-memory attribute (the launch's shape
        does not depend on ``batch``)."""
        del batch
        self.max_active_clusters(hidden)


KERNEL = CudaGRU()
BACKWARD_KERNEL = CudaGRUBackward()


def prepare_capture(cfg, rows: int, backward: bool) -> None:
    """Before a CUDA graph capture of a step of configuration ``cfg`` at
    ``rows`` batch rows: the host work of the GRU kernels that its
    generator launches, the forward's and, with ``backward``, the
    backward's. The sbert text path launches none."""
    if cfg.text_encoder == "sbert":
        return
    KERNEL.prepare(rows, cfg.char_rnn_hidden)
    if backward:
        BACKWARD_KERNEL.prepare(rows, cfg.char_rnn_hidden)


def _check(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
           *per_step: torch.Tensor) -> None:
    if x_proj.dim() != 3 or x_proj.shape[2] % 3:
        raise ValueError(f"x_proj must be (L, B, 3H), got {tuple(x_proj.shape)}")
    length, batch, h3 = x_proj.shape
    hidden = h3 // 3
    if tuple(w_hh.shape) != (3 * hidden, hidden) or \
            tuple(b_hh.shape) != (3 * hidden,):
        raise ValueError(f"w_hh must be (3H, H) and b_hh (3H,) for H={hidden}"
                         f", got {tuple(w_hh.shape)} and {tuple(b_hh.shape)}")
    for t in per_step:
        if tuple(t.shape) != (length, batch, hidden):
            raise ValueError(f"outputs and their gradient must be (L, B, H) ="
                             f" {(length, batch, hidden)}, got "
                             f"{tuple(t.shape)}")
    for t in (x_proj, w_hh, b_hh, *per_step):
        if t.dtype != torch.float32:
            raise TypeError(f"GRU tensors must be float32, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"a GRU tensor is on {t.device}, x_proj on "
                             f"{x_proj.device}")


def _check_pair(fwd: Sequence[torch.Tensor],
                bwd: Sequence[torch.Tensor]) -> torch.device:
    """Both directions of a layer are valid and share device and shape;
    returns the device."""
    for d in (fwd, bwd):
        _check(*d)
        if d[0].device != fwd[0].device or d[0].shape != fwd[0].shape:
            raise ValueError("both directions must share device and shape, "
                             f"got {tuple(fwd[0].shape)} on {fwd[0].device} "
                             f"and {tuple(d[0].shape)} on {d[0].device}")
    return fwd[0].device


def gru_recurrence(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """(L, B, 3H) input projections -> (L, B, H) hidden states, float32.

    ``w_hh`` is torch's ``weight_hh`` (3H, H), ``b_hh`` is (3H,). No
    gradient: ``gru_recurrence_grad`` is the differentiable form."""
    _check(x_proj, w_hh, b_hh)
    if x_proj.device.type == "cpu":
        return gru_recurrence_plain(x_proj, w_hh, b_hh, reverse)
    if x_proj.device.type != "cuda":
        raise RuntimeError(f"no GRU kernel for device {x_proj.device}")
    return KERNEL([(x_proj.contiguous(), w_hh.contiguous(),
                    b_hh.contiguous(), reverse)])[0]


def gru_bidirectional_forward(fwd: Sequence[torch.Tensor],
                              bwd: Sequence[torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gru_recurrence`` for both directions of a layer: ``fwd`` and
    ``bwd`` are each (x_proj, w_hh, b_hh), the first run left to right, the
    second right to left; returns the hidden states of each. On the card,
    one kernel launch for both."""
    device = _check_pair(fwd, bwd)
    if device.type == "cpu":
        return (gru_recurrence_plain(*fwd, False),
                gru_recurrence_plain(*bwd, True))
    if device.type != "cuda":
        raise RuntimeError(f"no GRU kernel for device {device}")
    return tuple(KERNEL([(*(t.contiguous() for t in d), reverse)
                         for d, reverse in ((fwd, False), (bwd, True))]))


def gru_recurrence_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """The kernel's function as a Python loop over t (the JAX scan path's
    gate math, ``ops/rnn.py:GRULayer``)."""
    length, batch, h3 = x_proj.shape
    hidden = h3 // 3
    h = x_proj.new_zeros((batch, hidden))
    out = x_proj.new_empty((length, batch, hidden))
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        hp = torch.matmul(h, w_hh.t()) + b_hh
        xr, xz, xn = x_proj[t].split(hidden, dim=1)
        hr, hz, hn = hp.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[t] = h
    return out


def gru_recurrence_backward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, outs: torch.Tensor,
                            grad: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradient of ``gru_recurrence`` from its outputs ``outs`` and
    their cotangent ``grad``: (dx_proj (L, B, 3H), dW_hh (3H, H),
    db_hh (3H,)), float32."""
    _check(x_proj, w_hh, b_hh, outs, grad)
    if x_proj.device.type == "cpu":
        return gru_backward_plain(x_proj, w_hh, b_hh, outs, grad, reverse)
    if x_proj.device.type != "cuda":
        raise RuntimeError(f"no GRU kernel for device {x_proj.device}")
    return _backward_cuda([(x_proj, w_hh, b_hh, outs, grad, reverse)])[0]


def gru_bidirectional_backward(fwd: Sequence[torch.Tensor],
                               bwd: Sequence[torch.Tensor]
                               ) -> Tuple[Tuple[torch.Tensor, ...],
                                          Tuple[torch.Tensor, ...]]:
    """``gru_recurrence_backward`` for both directions of a layer: ``fwd``
    and ``bwd`` are each (x_proj, w_hh, b_hh, outs, grad), the first run
    left to right, the second right to left; returns (dx_proj, dW_hh,
    db_hh) for each. On the card, one kernel launch for both."""
    device = _check_pair(fwd, bwd)
    if device.type == "cpu":
        return (gru_backward_plain(*fwd, False),
                gru_backward_plain(*bwd, True))
    if device.type != "cuda":
        raise RuntimeError(f"no GRU kernel for device {device}")
    return tuple(_backward_cuda([(*fwd, False), (*bwd, True)]))


def _backward_cuda(directions):
    """One backward launch for every direction in ``directions`` (tuples
    x_proj, w_hh, b_hh, outs, grad, reverse), the products around it per
    direction."""
    prepared = []
    for x_proj, w_hh, b_hh, outs, grad, reverse in directions:
        length, batch, h3 = x_proj.shape
        hidden = h3 // 3
        w_hh, b_hh = w_hh.contiguous(), b_hh.contiguous()
        outs, grad = outs.contiguous(), grad.contiguous()
        # Every step's h_prev is a saved output, so the gate pre-activations
        # are one product ahead of the kernel; the kernel keeps only W_hh's
        # columns.
        hp_outs = torch.addmm(b_hh, outs.view(length * batch, hidden),
                              w_hh.t()).view(length, batch, h3)
        prepared.append((x_proj.contiguous(), hp_outs, outs, grad, w_hh,
                         b_hh, reverse))
    results = []
    for (_, _, outs, _, _, _, reverse), (dxp, dhp) in zip(
            prepared, BACKWARD_KERNEL(prepared)):
        length, batch, hidden = outs.shape
        outs_flat = outs.view(length * batch, hidden)
        # dW_hh = sum over steps of dhp[t]^T h_prev[t]; the first step's
        # h_prev is zero.
        dhp_flat = dhp.view(length * batch, 3 * hidden)
        if reverse:
            dw = dhp_flat[:-batch].t() @ outs_flat[batch:]
        else:
            dw = dhp_flat[batch:].t() @ outs_flat[:-batch]
        results.append((dxp, dw, dhp_flat.sum(0)))
    return results


def gru_backward_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, outs: torch.Tensor,
                       grad: torch.Tensor, reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as a Python loop over t against the forward's order,
    step for step the JAX kernel's ``_bwd``."""
    length, batch, h3 = x_proj.shape
    hidden = h3 // 3
    zeros = x_proj.new_zeros((batch, hidden))
    dxp = torch.empty_like(x_proj)
    dw = torch.zeros_like(w_hh)
    db = torch.zeros_like(b_hh)
    dh_next = x_proj.new_zeros((batch, hidden))
    for t in (range(length) if reverse else range(length - 1, -1, -1)):
        tp = t + 1 if reverse else t - 1             # step of h_prev
        h_prev = outs[tp] if 0 <= tp < length else zeros
        dh = dh_next + grad[t]
        hp = torch.matmul(h_prev, w_hh.t()) + b_hh
        xr, xz, xn = x_proj[t].split(hidden, dim=1)
        hr, hz, hn = hp.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh * (h_prev - n) * z * (1.0 - z)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dh_next = dh * z + torch.matmul(dhp, w_hh)
        dw += torch.matmul(dhp.t(), h_prev)
        db += dhp.sum(0)
    return dxp, dw, db


# ------------------------------------------------------------ custom ops
# The four functions above as ``torch.library`` custom ops, so that a
# traced program (``torch.export``, ``serve/export.py``) holds one GRU
# node where a trace of the ctypes launches would hold nothing: each has
# a fake implementation (shapes only) and one implementation for CPU and
# CUDA tensors, the function above, which takes the plain loop for a CPU
# tensor and the kernel for a CUDA tensor. Eager steps, CUDA-graph
# captures and exported programs all go through them.
NAMESPACE = "vgm_torch"
_DEVICES = ("cpu", "cuda")


def _gru_forward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    return gru_recurrence(x_proj, w_hh, b_hh, reverse)


def _gru_backward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor, outs: torch.Tensor, grad: torch.Tensor,
                  reverse: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return gru_recurrence_backward(x_proj, w_hh, b_hh, outs, grad, reverse)


def _bigru_forward(x_fwd: torch.Tensor, w_fwd: torch.Tensor,
                   b_fwd: torch.Tensor, x_bwd: torch.Tensor,
                   w_bwd: torch.Tensor, b_bwd: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return gru_bidirectional_forward((x_fwd, w_fwd, b_fwd),
                                     (x_bwd, w_bwd, b_bwd))


def _bigru_backward(x_fwd: torch.Tensor, w_fwd: torch.Tensor,
                    b_fwd: torch.Tensor, outs_fwd: torch.Tensor,
                    grad_fwd: torch.Tensor, x_bwd: torch.Tensor,
                    w_bwd: torch.Tensor, b_bwd: torch.Tensor,
                    outs_bwd: torch.Tensor, grad_bwd: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor, torch.Tensor]:
    fwd, bwd = gru_bidirectional_backward(
        (x_fwd, w_fwd, b_fwd, outs_fwd, grad_fwd),
        (x_bwd, w_bwd, b_bwd, outs_bwd, grad_bwd))
    return (*fwd, *bwd)


def _custom_op(name: str, fn):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", fn,
                                   mutates_args=(), device_types=_DEVICES)


gru_forward_op = _custom_op("gru_forward", _gru_forward)
gru_backward_op = _custom_op("gru_backward", _gru_backward)
bigru_forward_op = _custom_op("bigru_forward", _bigru_forward)
bigru_backward_op = _custom_op("bigru_backward", _bigru_backward)


def _hidden_states(x_proj: torch.Tensor) -> torch.Tensor:
    length, batch, h3 = x_proj.shape
    return x_proj.new_empty((length, batch, h3 // 3))


def _gradients(x_proj, w_hh, b_hh):
    return (torch.empty_like(x_proj), torch.empty_like(w_hh),
            torch.empty_like(b_hh))


@gru_forward_op.register_fake
def _(x_proj, w_hh, b_hh, reverse):
    _check(x_proj, w_hh, b_hh)
    return _hidden_states(x_proj)


@gru_backward_op.register_fake
def _(x_proj, w_hh, b_hh, outs, grad, reverse):
    _check(x_proj, w_hh, b_hh, outs, grad)
    return _gradients(x_proj, w_hh, b_hh)


@bigru_forward_op.register_fake
def _(x_fwd, w_fwd, b_fwd, x_bwd, w_bwd, b_bwd):
    _check_pair((x_fwd, w_fwd, b_fwd), (x_bwd, w_bwd, b_bwd))
    return _hidden_states(x_fwd), _hidden_states(x_bwd)


@bigru_backward_op.register_fake
def _(x_fwd, w_fwd, b_fwd, outs_fwd, grad_fwd, x_bwd, w_bwd, b_bwd,
      outs_bwd, grad_bwd):
    _check_pair((x_fwd, w_fwd, b_fwd, outs_fwd, grad_fwd),
                (x_bwd, w_bwd, b_bwd, outs_bwd, grad_bwd))
    return (*_gradients(x_fwd, w_fwd, b_fwd),
            *_gradients(x_bwd, w_bwd, b_bwd))


class GRURecurrence:
    """The gradient of ``gru_forward_op`` (``register_autograd``): the
    forward saves (x_proj, w_hh, b_hh, outs), the backward runs
    ``gru_backward_op`` on them."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_proj, w_hh, b_hh, reverse = inputs
        ctx.save_for_backward(x_proj, w_hh, b_hh, output)
        ctx.reverse = reverse

    @staticmethod
    def backward(ctx, grad):
        x_proj, w_hh, b_hh, outs = ctx.saved_tensors
        dxp, dw, db = gru_backward_op(x_proj, w_hh, b_hh, outs,
                                      grad.contiguous(), ctx.reverse)
        return dxp, dw, db, None


class BiGRURecurrence:
    """The gradient of ``bigru_forward_op`` (``register_autograd``): the
    forward saves (x_proj, w_hh, b_hh, outs) per direction, the backward
    runs ``bigru_backward_op``, one kernel launch for the pair."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_f, w_f, b_f, x_b, w_b, b_b = inputs
        ctx.save_for_backward(x_f, w_f, b_f, output[0],
                              x_b, w_b, b_b, output[1])

    @staticmethod
    def backward(ctx, grad_fwd, grad_bwd):
        x_f, w_f, b_f, outs_f, x_b, w_b, b_b, outs_b = ctx.saved_tensors
        # Looked up at call time: the tests drive the backward on fake CUDA
        # tensors with the op's implementation in its place.
        return bigru_backward_op(x_f, w_f, b_f, outs_f,
                                 grad_fwd.contiguous(), x_b, w_b, b_b,
                                 outs_b, grad_bwd.contiguous())


gru_forward_op.register_autograd(GRURecurrence.backward,
                                 setup_context=GRURecurrence.setup_context)
bigru_forward_op.register_autograd(
    BiGRURecurrence.backward, setup_context=BiGRURecurrence.setup_context)


def bigru_recurrence_grad(x_fwd: torch.Tensor, w_fwd: torch.Tensor,
                          b_fwd: torch.Tensor, x_bwd: torch.Tensor,
                          w_bwd: torch.Tensor, b_bwd: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gru_bidirectional_forward`` (the second direction reversed) as the
    custom op, which autograd differentiates with one backward launch for
    the pair."""
    return bigru_forward_op(x_fwd, w_fwd, b_fwd, x_bwd, w_bwd, b_bwd)


def gru_recurrence_grad(x_proj: torch.Tensor, w_hh: torch.Tensor,
                        b_hh: torch.Tensor,
                        reverse: bool = False) -> torch.Tensor:
    """``gru_recurrence`` as the custom op, which autograd
    differentiates."""
    return gru_forward_op(x_proj, w_hh, b_hh, reverse)
