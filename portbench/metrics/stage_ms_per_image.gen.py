"""stage_ms_per_image.gen: the condition, adapter and tokenizer-decode
stages of the window's completed calls (the pipeline's own `timings`,
synchronised at each stage's end; traced run), ms over their images."""


def read(ctx):
    w = ctx.window
    calls = [c for c in w.get("calls", []) if c["complete"] and c["stages"]]
    if w.get("kind") != "gen" or not calls:
        return None
    s = sum(c["stages"]["condition"] + c["stages"]["adapter"] + c["stages"]["vq_decode"]
            for c in calls)
    return 1e3 * s / (len(calls) * w["batch"])
