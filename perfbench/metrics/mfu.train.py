"""The whole fit step's share of the chip's peak (forward, backward and
Adam)."""

from perfbench.harness.readers import mfu


def read(s):
    return mfu(s, "train", "step")
