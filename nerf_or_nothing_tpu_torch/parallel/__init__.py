"""Data parallelism on ``torch.distributed`` (``mesh.py``)."""
