"""The whole served frame's share of the chip's peak (the forward and the
frame's bytes)."""

from perfbench.harness.readers import mfu


def read(s):
    return mfu(s, "serve", "frame")
