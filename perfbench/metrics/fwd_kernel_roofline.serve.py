"""The forward kernel's share of its roofline in a served frame."""

from perfbench.harness.readers import kernel_roofline


def read(s):
    return kernel_roofline(s, "serve", "forward")
