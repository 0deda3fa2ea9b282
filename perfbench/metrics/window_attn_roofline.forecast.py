"""The band attention's least time over its kernels' measured time in a forecast, in % (K6)."""

from perfbench.harness.readers import window_attention_roofline


def read(trace, ctx):
    return window_attention_roofline(trace, ctx, "forecast")
