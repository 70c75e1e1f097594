"""Device time per served frame outside the program's CUDA kernels."""

from perfbench.harness.readers import glue_device_ms


def read(s):
    return glue_device_ms(s, "serve")
