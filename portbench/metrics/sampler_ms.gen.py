"""sampler_ms.gen: host ms a decode step inside `decode.sample` (the CFG mix
and the sampler), over the profiled slice's complete `decode.step` spans."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "gen")
    if s is None or not s.count("decode.step") or not s.count("decode.sample"):
        return None
    return s.host_ms("decode.sample", within="decode.step") / s.count("decode.step")
