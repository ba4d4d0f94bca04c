"""The mesh across processes: the ``data`` and ``model`` axes of the JAX
package's ``parallel/mesh.py``.

The JAX package builds a ``Mesh`` over the chips shaped (data, model),
replicates the parameters, shards the batch over ``data``, may shard the
widest generator kernels over ``model`` (``partition_params``), and lets
XLA insert the collectives. The port runs one process per card in a
``torch.distributed`` process group (``parallel/distributed.py``).
``make_mesh(model_parallel)`` lays the ranks out as JAX's
``reshape(n // tp, tp)``: rank r has data index ``r // tp`` and model index
``r % tp``; the ranks of one data index form a model group, the ranks of
one model index a data group. Without ``make_mesh`` a process group is a
mesh of data alone (model_parallel=1), and without a process group a mesh
of one, where every function here is the identity and runs no collective.

The data axis. Each data index holds its rows of the global batch
(``local_rows``); the code that needs a collective calls one here, over
the data group:

* ``ops/norms.py``: BatchNorm's statistics over the global batch
  (``all_reduce_sum``, which carries the gradient across processes);
* ``train/step.py``: each network's gradients averaged over the data
  indices before clipping and Adam (``average_gradients_``), and the
  metrics averaged before they leave a step (``mean_over_processes``);
* ``ops/sampling.py``, ``ops/rnn.py``: the reparameterisation noise and
  the BiGRU's dropout masks drawn at the global batch's shape from the
  step's generator, this data index's rows taken (``global_rows``), so
  the model ranks of one data index draw the same.

So the run equals one process with the same global batch: the losses are
global-batch means and BatchNorm reduces over the global batch.

The model axis (tensor parallelism). ``partition_params`` applies the JAX
rule to the generator: a leaf with at least 2 dims whose output dim is at
least ``kernel_min_ch`` and divisible by tp is replaced on each model rank
by its contiguous block of that dim, in model-rank order, so its Adam
moments are block-sized too. The port's layers read a parameter's block
through two functions here:

* ``column_parallel``: a conv, transposed conv, linear or FiLM predictor
  with a sharded weight computes its own output channels; a gather over
  the model group rebuilds the whole output (its backward takes this
  rank's slice, not the sum over ranks that
  ``torch.distributed.nn.functional.all_gather`` would give), the bias is
  added after it, and the layer's input passes through an op that is the
  identity forward and an all-reduce-sum over the model group backward;
* ``gather_at_use``: a weight that an op consumes whole (the GRU's
  ``weight_ih`` / ``weight_hh`` ahead of the kernels, oldv's ``pos_enc``)
  is gathered; its gradient is this rank's slice of the full gradient.

Every model rank of a data index thus holds the same activations, and its
whole leaves get the same gradients (``average_gradients_`` averages them
over every process, so rounding cannot part the ranks). ``gather_params``
returns the generator's state dict in the layout of an unpartitioned one.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Sequence)

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
# The attribute a partitioned parameter carries: the dim it is cut along.
SHARD_DIM = "_vgm_model_dim"

# The differentiable all-reduce of ``torch.distributed.nn`` warns that it is
# deprecated at each process's first call; its replacement is private.
warnings.filterwarnings(
    "ignore", message="torch.distributed.nn.functional.all_reduce is "
    "deprecated", category=FutureWarning)


def active() -> bool:
    """A process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def process_index() -> int:
    return dist.get_rank() if active() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) layout of the processes and this process's place
    in it. A group of None is the whole process group (or none)."""
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


_MESH: Optional[Mesh] = None


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh over the process group shaped (n // model_parallel,
    model_parallel), which every function here then uses. Every process
    calls it with the same ``model_parallel``, which must divide the
    process count."""
    global _MESH
    n, rank = process_count(), process_index()
    tp = int(model_parallel)
    if tp < 1 or n % tp:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} processes")
    data_group = model_group = None
    if tp > 1:
        # Every process creates every group, in the same order.
        for i in range(n // tp):
            group = dist.new_group(list(range(i * tp, (i + 1) * tp)))
            if rank // tp == i:
                model_group = group
        for j in range(tp):
            group = dist.new_group(list(range(j, n, tp)))
            if rank % tp == j:
                data_group = group
    _MESH = Mesh(n // tp, tp, rank // tp, rank % tp, data_group, model_group)
    return _MESH


def reset_mesh() -> None:
    """Forget the mesh (the process group is being left)."""
    global _MESH
    _MESH = None


def current_mesh() -> Mesh:
    """The mesh of ``make_mesh``, else the data axis over every process."""
    if _MESH is not None and active() \
            and _MESH.data * _MESH.model == process_count():
        return _MESH
    return Mesh(process_count(), 1, process_index(), 0)


def data_count() -> int:
    return current_mesh().data


def data_index() -> int:
    return current_mesh().data_index


def model_count() -> int:
    return current_mesh().model


def _group(group):
    return dist.group.WORLD if group is None else group


# ------------------------------------------------------------ data axis
def local_rows(global_rows: int) -> slice:
    """This data index's contiguous block of a global batch's rows (data
    indices in order, equal blocks)."""
    n, i = data_count(), data_index()
    if global_rows % n:
        raise ValueError(f"a global batch of {global_rows} rows does not "
                         f"split over {n} processes")
    per = global_rows // n
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Mapping) -> Dict:
    """This data index's rows of a global batch: every entry (tensor,
    array or list) cut along its first axis."""
    rows = local_rows(len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def global_rows(draw: Callable[[Sequence[int]], torch.Tensor],
                shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, where ``shape`` holds this data index's rows along
    ``dim``: with several data indices ``draw`` runs at the global shape
    and this index's rows are taken, so every process draws what one
    process with the global batch would, and keeps its own part."""
    n = data_count()
    if n == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= n
    return draw(tuple(full)).narrow(dim, data_index() * shape[dim],
                                    shape[dim])


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the data group, differentiable: its backward sums the
    gradient over the group (``torch.distributed.nn.functional``)."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM,
                      group=_group(current_mesh().data_group))


def _mean_(grads: Sequence[torch.Tensor], group, count: int) -> None:
    """Each of ``grads`` becomes its mean over ``group`` of ``count``
    processes, with one all-reduce of a flat buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_group(group))
    flat.div_(count)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def average_gradients_(params: Iterable[nn.Parameter]) -> None:
    """Each gradient becomes its mean over the data indices. A whole
    parameter's is averaged over every process: the model ranks of a data
    index compute it from the same rows, so that is the data group's mean,
    and it leaves them equal bit for bit where their gradients differ in
    rounding (the card's float32 atomics), so their parameters never part.
    A partitioned parameter's block is averaged over its data group (the
    ranks that hold the same block). One all-reduce for each kind.
    Parameters without a gradient are left alone (the same set on every
    process: the processes run one graph)."""
    if not active():
        return
    params = [p for p in params if p.grad is not None]
    mesh = current_mesh()
    _mean_([p.grad for p in params if sharded_dim(p) is None], None,
           process_count())
    _mean_([p.grad for p in params if sharded_dim(p) is not None],
           mesh.data_group, mesh.data)


def mean_over_processes(metrics: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over the data group, with one all-reduce."""
    if not active() or not metrics:
        return dict(metrics)
    mesh = current_mesh()
    stacked = torch.stack(list(metrics.values()))
    dist.all_reduce(stacked, group=_group(mesh.data_group))
    stacked.div_(mesh.data)
    return dict(zip(metrics, stacked.unbind()))


def _flag_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(flag: bool) -> bool:
    """Whether ``flag`` holds on every process; raises when some processes
    have it and others do not."""
    if not active():
        return flag
    t = torch.tensor([int(flag), -int(flag)], device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    lowest, highest = int(t[0]), -int(t[1])
    if lowest != highest:
        raise RuntimeError("the processes disagree (some see a file the "
                           "others do not): the workdir must be on storage "
                           "that every process shares")
    return bool(lowest)


def barrier() -> None:
    if active():
        dist.barrier()


def replicate_(module: nn.Module) -> nn.Module:
    """Make ``module``'s parameters and buffers process 0's on every
    process (a broadcast of each); a partitioned parameter's block
    becomes that of data index 0 with the same model index."""
    if active():
        mesh = current_mesh()
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                if sharded_dim(t) is None:
                    dist.broadcast(t.data, src=0)
                else:
                    dist.broadcast(t.data, src=mesh.model_index,
                                   group=_group(mesh.data_group))
    return module


# ----------------------------------------------------------- model axis
def sharded_dim(t: torch.Tensor) -> Optional[int]:
    """The dim a partitioned parameter is cut along, else None."""
    return getattr(t, SHARD_DIM, None)


def _dense(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in ``like``'s memory format: channels-last for the card's
    channels-last activations, else contiguous (the CPU's convolutions
    want NCHW memory, ``ops/convblocks.py:nhwc_to_nchw``)."""
    channels_last = (like.dim() == 4 and not like.is_contiguous()
                     and like.is_contiguous(memory_format=torch.channels_last))
    return t.contiguous(memory_format=torch.channels_last if channels_last
                        else torch.contiguous_format)


def gather_tensor(t: torch.Tensor, dim: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The model ranks' blocks of ``t`` along ``dim``, concatenated in
    model-rank order, in ``t``'s memory format (no autograd)."""
    mesh = mesh or current_mesh()
    if mesh.model == 1:
        return t
    part = t.detach().movedim(dim, 0).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.model)]
    dist.all_gather(parts, part, group=mesh.model_group)
    return _dense(torch.cat(parts).movedim(0, dim), t)


class _GatherFromModel(torch.autograd.Function):
    """Forward: the blocks of every model rank along ``dim``; backward:
    this rank's slice of the gradient (every model rank computes the same
    downstream gradient, so a sum over ranks would multiply it by tp)."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.size, ctx.index = dim, t.shape[dim], mesh.model_index
        return gather_tensor(t, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        block = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return _dense(block, grad), None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity; backward: the sum over the model group (each
    rank's input gradient holds its output channels' part)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


def gather_at_use(p: torch.Tensor) -> torch.Tensor:
    """``p`` whole: a partitioned parameter gathered over the model group
    (its gradient is this rank's slice of the full one), else ``p``."""
    dim = sharded_dim(p)
    if dim is None:
        return p
    return _GatherFromModel.apply(p, dim, current_mesh())


def column_parallel(fn: Callable, x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fn(x, weight, bias)``, whose output channels (dim 1) are
    ``weight``'s output channels. With a partitioned ``weight``: ``fn`` on
    this rank's block without the bias, the blocks gathered over the model
    group, then the bias added to the whole output."""
    if sharded_dim(weight) is None:
        return fn(x, weight, bias)
    mesh = current_mesh()
    y = fn(_CopyToModel.apply(x, mesh), weight, None)
    y = _GatherFromModel.apply(y, 1, mesh)
    if bias is not None:
        y = y + bias.to(y.dtype).view((1, -1) + (1,) * (y.dim() - 2))
    return y


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in place (no autograd)."""
    mesh = current_mesh()
    if mesh.model > 1:
        dist.all_reduce(t, group=mesh.model_group)
    return t


# The dim of the port's parameter that holds the JAX leaf's last (output)
# dim, by the weight bridge's layout change (``utils/port_jax.py``).
_PORT_OUTPUT_DIM = {"conv": 0, "dense": 0, "gru": 0, "conv1d": 0,
                    "tconv": 1, "nhwc": 1}


def partition_params(generator: nn.Module, mesh: Optional[Mesh] = None,
                     kernel_min_ch: int = 512) -> nn.Module:
    """Tensor-parallel placement of the generator's widest kernels, the
    JAX package's rule on the JAX leaf each parameter is bridged from: at
    least 2 dims, the last (output) dim at least ``kernel_min_ch`` and
    divisible by the model count. Each such parameter becomes this model
    rank's contiguous block of its output dim, in place (the same
    ``Parameter``). Call it after ``replicate_`` and before the first
    optimizer step, so that Adam's moments are block-sized. Biases, norms
    and the other networks stay whole."""
    from vae_gan_mark_tpu_torch.utils.port_jax import generator_entries

    mesh = mesh or current_mesh()
    tp = mesh.model
    if tp == 1:
        return generator
    params = dict(generator.named_parameters())
    with torch.no_grad():
        for e in generator_entries(generator.cfg):
            shape = e.shape
            if e.collection != "params" or not (
                    len(shape) >= 2 and shape[-1] >= kernel_min_ch
                    and shape[-1] % tp == 0):
                continue
            if e.kind not in _PORT_OUTPUT_DIM:
                raise ValueError(f"{e.key}: no tensor-parallel layout for "
                                 f"a {e.kind!r} leaf of shape {shape}")
            p, dim = params[e.key], _PORT_OUTPUT_DIM[e.kind]
            if sharded_dim(p) is not None or p.shape[dim] != shape[-1]:
                raise ValueError(f"{e.key}: {tuple(p.shape)} is not the "
                                 f"whole leaf {shape}")
            size = shape[-1] // tp
            p.data = p.data.narrow(dim, mesh.model_index * size, size).clone(
                memory_format=torch.contiguous_format)
            setattr(p, SHARD_DIM, dim)
    return generator


def gather_params(generator: nn.Module) -> Dict[str, torch.Tensor]:
    """The generator's state dict in the layout of an unpartitioned one:
    every partitioned parameter gathered over the model group."""
    params = dict(generator.named_parameters())
    out = {}
    for key, value in generator.state_dict().items():
        dim = sharded_dim(params[key]) if key in params else None
        out[key] = value if dim is None else gather_tensor(value, dim)
    return out
