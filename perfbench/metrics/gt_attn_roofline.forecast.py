"""The graph attention's least time over its kernels' measured time in a forecast, in % (kernel K1)."""

from perfbench.harness.readers import gt_attention_roofline


def read(trace, ctx):
    return gt_attention_roofline(trace, ctx, "forecast")
