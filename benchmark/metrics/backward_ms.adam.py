"""The self time of the Adam step's torch.autograd.grad (span adam.backward, less the spans inside it on any thread) per traced step."""

from benchmark.harness.spans import self_per_unit


def read(ctx):
    return self_per_unit(ctx, "adam.backward")
