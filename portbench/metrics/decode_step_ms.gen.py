"""decode_step_ms.gen: the tokens stage of the window's completed calls (the
pipeline's own `timings`; traced run), ms per generated token of a row:
prefill, decode steps and sampling together."""


def read(ctx):
    w = ctx.window
    calls = [c for c in w.get("calls", []) if c["complete"] and c["stages"]]
    if w.get("kind") != "gen" or not calls:
        return None
    return 1e3 * sum(c["stages"]["tokens"] for c in calls) / (len(calls) * w["tokens_per_image"])
