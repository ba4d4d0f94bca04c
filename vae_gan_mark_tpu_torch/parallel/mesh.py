"""The data axis across processes (the JAX package's ``parallel/mesh.py``,
its ``data`` axis).

The JAX package builds a ``Mesh`` over the chips, replicates the parameters,
shards the batch over the ``data`` axis and lets XLA insert the collectives.
The port runs one process per card in a ``torch.distributed`` process group
(``parallel/distributed.py``); each process holds the parameters whole and
its own rows of the global batch, and the code that needs a collective
calls one here:

* ``ops/norms.py``: BatchNorm's statistics over the global batch
  (``all_reduce_sum``, which carries the gradient across processes);
* ``train/step.py``: each network's gradients averaged over the processes
  before clipping and Adam (``average_gradients_``), and the metrics
  averaged before they leave a step (``mean_over_processes``);
* ``ops/sampling.py``, ``ops/rnn.py``: the reparameterisation noise and
  the BiGRU's dropout masks drawn at the global batch's shape from the
  step's generator, this process's rows taken (``global_rows``).

So an N-process run equals one process with the same global batch: the
losses are global-batch means and BatchNorm reduces over the global batch.
Every process holds the same number of rows (``local_rows``); the steps
count on it.

Without a process group every function here is the identity and runs no
collective, and the code that calls it computes what it did before.
``partition_params`` (the JAX package's ``model`` axis, tensor
parallelism) is not ported.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Callable, Dict, Iterable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"

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


def local_rows(global_rows: int) -> slice:
    """This process's contiguous block of a global batch's rows (processes
    in rank order, equal blocks)."""
    n, i = process_count(), process_index()
    if global_rows % n:
        raise ValueError(f"a global batch of {global_rows} rows does not "
                         f"split over {n} processes")
    per = global_rows // n
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Mapping) -> Dict:
    """This process's rows of a global batch: every entry (tensor, array
    or list) cut along its first axis."""
    rows = local_rows(len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def global_rows(draw: Callable[[Sequence[int]], torch.Tensor],
                shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, where ``shape`` holds this process's rows along
    ``dim``: with several processes ``draw`` runs at the global shape and
    this process's rows are taken, so every process draws what one process
    with the global batch would, and keeps its own part."""
    n = process_count()
    if n == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= n
    return draw(tuple(full)).narrow(dim, process_index() * shape[dim],
                                    shape[dim])


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over processes, differentiable: its backward sums the
    gradient over processes (``torch.distributed.nn.functional``)."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM)


def average_gradients_(params: Iterable[nn.Parameter]) -> None:
    """Each gradient becomes its mean over processes, with one all-reduce
    of a flat buffer. Parameters without a gradient are left alone (the
    same set on every process: the processes run one graph)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(process_count())
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_over_processes(metrics: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over processes, with one all-reduce."""
    if not active() or not metrics:
        return dict(metrics)
    stacked = torch.stack(list(metrics.values()))
    dist.all_reduce(stacked)
    stacked.div_(process_count())
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
    process (a broadcast of each)."""
    if active():
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                dist.broadcast(t.data, src=0)
    return module
