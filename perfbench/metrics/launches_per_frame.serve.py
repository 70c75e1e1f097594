"""Device kernels per served frame."""

from perfbench.harness.readers import launches


def read(s):
    return launches(s, "serve")
