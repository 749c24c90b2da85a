"""Kernels K1 and K2 over the traced updates: the bound of every attention
forward and backward the updates ran, from the frozen ``attention_bound``,
over the device time of the K1 and K2 kernels, in percent."""
from portbench.yardstick import attention_bound

NAMES = ("attention_fwd", "attention_bwd")


def read(trace):
    calls = trace.facts.get("attention_calls")
    spent = trace.device_s(names=NAMES)
    if trace.kind != "train" or not calls or not spent:
        return None
    least = sum(attention_bound(*c, backward=False)[0]
                + attention_bound(*c, backward=True)[0] for c in calls)
    return 100.0 * least / spent
