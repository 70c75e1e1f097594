"""Share of the traced fit steps with the device idle."""

from perfbench.harness.readers import device_idle_share


def read(s):
    return device_idle_share(s, "train")
