"""The band attention's least time over its kernels' measured time in training, in % (K6, K7_dq, K7_dkv)."""

from perfbench.harness.readers import window_attention_roofline


def read(trace, ctx):
    return window_attention_roofline(trace, ctx, "train")
