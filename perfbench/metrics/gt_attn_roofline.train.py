"""The graph attention's least time over its kernels' measured time in training, in % (kernels K1, K3, K4, K5)."""

from perfbench.harness.readers import gt_attention_roofline


def read(trace, ctx):
    return gt_attention_roofline(trace, ctx, "train")
