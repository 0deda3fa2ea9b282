"""Device kernels launched in the profiled stretch a forecast state (entry: inference.py)."""

from perfbench.harness.readers import launches_per_unit


def read(trace, ctx):
    return launches_per_unit(trace, ctx, "forecast")
