"""forward_ms.train: device ms a training step of the operations launched
inside `train.forward` (the compute copies through the loss, condition and
adapter included), in the profiled slice: their device time over the number
of complete spans (one a step)."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "train")
    if s is None or not s.count("train.forward"):
        return None
    return s.device_ms("train.forward") / s.count("train.forward")
