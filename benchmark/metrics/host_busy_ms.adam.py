"""The host's time per Adam step outside calls that wait for the card (any thread)."""

from benchmark.harness.layer import host_busy_ms


def read(ctx):
    return host_busy_ms(ctx)
