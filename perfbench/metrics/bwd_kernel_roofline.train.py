"""The backward kernel's share of its roofline in a fit step."""

from perfbench.harness.readers import kernel_roofline


def read(s):
    return kernel_roofline(s, "train", "backward")
