"""Model FLOPs of the traced updates (``yardstick.bicaptioning_train_flops``,
counted by the driver from each batch's shapes and valid caption lengths)
over their wall seconds at the bf16 peak, in percent."""
from portbench.yardstick import BF16_FLOPS


def read(trace):
    flops = trace.facts.get("model_flops")
    if trace.kind != "train" or not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * BF16_FLOPS)
