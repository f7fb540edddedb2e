"""optimizer_ms.train: device ms a step of the optimizer's multi-tensor
kernels (AdamW's foreach passes and the global norm) in the profiled slice."""
from portbench.harness.trace import kernel_time


def read(ctx):
    s = ctx.slice
    if not s or s.get("kind") != "train":
        return None
    t = kernel_time(s, "multi_tensor_apply")
    return 1e3 * t / s["steps"] if t > 0 else None
