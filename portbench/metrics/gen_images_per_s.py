"""gen_images_per_s: every image token generated in the window (a call cut
by the window's end counts the steps it ran), over the tokens of an image,
over the window's seconds (synchronised at both ends)."""


def read(ctx):
    w = ctx.window
    if w.get("kind") != "gen":
        return None
    return w["tokens"] / w["tokens_per_image"] / w["seconds"]
