"""Rank 0's device ms a step in NCCL's all-reduce kernels (names holding
``AllReduce``): the gradients' exchange and the loss's global sums, each
with its wait for the last rank."""
from benchmark.trace import device_s


def read(ctx):
    s = device_s(ctx.trace, "AllReduce")
    return ctx.per_unit_ms(s) if s > 0 else None
