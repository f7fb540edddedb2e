"""train_images_per_s: images of every training step run in the window over
the window's seconds (synchronised at both ends)."""


def read(ctx):
    w = ctx.window
    if w.get("kind") != "train":
        return None
    return w["steps"] * w["batch"] / w["seconds"]
