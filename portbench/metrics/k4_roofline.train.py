"""Kernel K4 (both stages) over the traced updates: the bound of every
BatchNorm backward the updates ran, from the frozen byte and operation
counts, over the device time of the K4 kernels, in percent."""
from portbench.yardstick import k4_bound_s

NAMES = ("bn_sums", "bn_dx")


def read(trace):
    shapes = trace.facts.get("bn_inputs")
    spent = trace.device_s(names=NAMES)
    if trace.kind != "train" or not shapes or not spent:
        return None
    return 100.0 * k4_bound_s(shapes) / spent
