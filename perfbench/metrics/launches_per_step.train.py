"""Device kernels per fit step."""

from perfbench.harness.readers import launches


def read(s):
    return launches(s, "train")
