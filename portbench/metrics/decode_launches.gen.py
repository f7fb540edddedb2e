"""decode_launches.gen: device operations (kernels, copies, fills) launched
inside the profiled slice's complete `decode.step` spans, over the number
of those spans: launches a decode step."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "gen")
    if s is None or not s.count("decode.step"):
        return None
    return s.launches("decode.step") / s.count("decode.step")
