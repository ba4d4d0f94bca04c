"""Data parallelism across processes: one process per card, joined in a
``torch.distributed`` process group (``distributed.py``), and the
collectives the steps call (``mesh.py``)."""
