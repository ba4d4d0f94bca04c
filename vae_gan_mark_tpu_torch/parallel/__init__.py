"""Parallelism across processes: one process per card, joined in a
``torch.distributed`` process group (``distributed.py``); the (data,
model) mesh, the collectives the steps call and the tensor-parallel
partition of the generator (``mesh.py``); the multi-process dry run
(``dryrun.py``)."""
