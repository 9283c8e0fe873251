"""MiB the CUDA graphs captured in set-up reserved for their memory pools:
the program's count of the pool's reserved bytes at each ``capture`` span
that started before the traced window."""
from benchmark.metrics._program_trace import setup_attr


def read(ctx):
    b = setup_attr(ctx, "capture", "pool_reserved_bytes")
    return None if b is None else b / 2**20
