"""Gradio demo (the JAX package's `demo.py`; the reference's demo/app.py and
demo/model.py): edge and depth control tabs over a shared pipeline,
per-condition GPT checkpoint hot-swap, c2i class names or t2i prompts, the
sampling controls. `DemoEngine` needs no gradio; `build_demo` and `main`
import it inside themselves, and the CLI stays the primary interface.

Run: python -m controlar_tpu_torch.demo --gpt-ckpt ... --vq-ckpt ... \
         [--ckpt-map canny=edge.safetensors,depth=depth.safetensors] \
         [--t5-path /path/flan-t5-xl] [--device cuda]
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


class DemoEngine:
    """One pipeline per condition type, cached, with that condition's GPT
    checkpoint swapped in when `ckpt_map` names one; `process()` runs one
    image."""

    def __init__(self, pipe_factory, ckpt_map: Optional[Dict[str, str]] = None, t5=None):
        self._factory = pipe_factory
        self._ckpt_map = ckpt_map or {}
        self._pipes: Dict[str, object] = {}
        self._t5 = t5

    def get_pipe(self, condition_type: str):
        if condition_type not in self._pipes:
            pipe = self._factory(condition_type)
            ckpt = self._ckpt_map.get(condition_type)
            if ckpt:
                # the reference reloads the condition's weights into the live
                # model; here the pipeline gets the loaded GPT in the
                # factory's GPT's dtype and device
                from controlar_tpu_torch import checkpoint as ckpt_lib
                from controlar_tpu_torch.models.gpt import param_dtype

                gpt = ckpt_lib.load_gpt_checkpoint(ckpt, pipe.gpt_cfg, param_dtype(pipe.gpt),
                                                   pipe.device)
                pipe = dataclasses.replace(pipe, gpt=gpt)
            self._pipes[condition_type] = pipe
        return self._pipes[condition_type]

    def process(self, image: np.ndarray, condition_type: str, prompt: str = "",
                label: str = "0", cfg_scale: float = 4.0, temperature: float = 1.0,
                top_k: int = 2000, top_p: float = 1.0, control_strength: float = 1.0,
                seed: int = 0, canny_low: int = 100, canny_high: int = 200,
                preprocess: bool = True) -> np.ndarray:
        from PIL import Image

        pipe = self.get_pipe(condition_type)
        gh, gw = pipe.gpt_cfg.grid
        img = np.asarray(Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
                         .resize((gw * 16, gh * 16)))[None]
        kw = dict(condition_images=img, cfg_scale=float(cfg_scale),
                  temperature=float(temperature), top_k=int(top_k), top_p=float(top_p),
                  control_strength=float(control_strength), seed=int(seed),
                  canny_low=int(canny_low), canny_high=int(canny_high),
                  preprocess_condition=bool(preprocess))
        if pipe.gpt_cfg.model_type == "t2i":
            if self._t5 is None:
                raise ValueError("t2i demo needs --t5-path")
            caption_emb, emb_masks = self._t5.get_text_embeddings([prompt])
            out = pipe.generate(caption_emb=caption_emb, emb_masks=emb_masks, **kw)
        else:
            from controlar_tpu_torch.data.imagenet_labels import lookup_class

            out = pipe.generate(labels=np.asarray([lookup_class(label)]), **kw)
        return out[0]


DESCRIPTION = (
    "# ControlAR — controllable autoregressive image generation\n"
    "### Edge (canny/hed/lineart) and Depth control tabs; the PyTorch port of "
    "the reference demo (demo/app.py)."
)

# example rows of the reference's bundled examples (demo/app_edge.py:11-24,
# app_depth.py), shown when the files exist
EDGE_EXAMPLES = [
    ["condition/example/t2i/landscape.jpg",
     "Landscape photos with snow on the mountains in the distance and clear "
     "reflections in the lake near by"],
    ["condition/example/t2i/girl.jpg", "A girl with blue hair"],
    ["condition/example/t2i/eye.png", "A vivid drawing of an eye with a few pencils nearby"],
]
DEPTH_EXAMPLES = [
    ["condition/example/t2i/bird.jpg", "colorful bird"],
    ["condition/example/t2i/house.jpg", "a house in the woods"],
]


def _create_tab(gr, engine: DemoEngine, model_type: str, tab: str):
    """One control tab: image, prompt or class, the advanced-options
    accordion and the examples."""
    import os as _os
    import random as _random

    is_edge = tab == "edge"
    with gr.Row():
        with gr.Column():
            inp = gr.Image(label="condition image")
            if model_type == "t2i":
                text = gr.Textbox(label="Prompt", value="a high-quality image")
            else:
                text = gr.Textbox(label="ImageNet class (id or name)", value="207")
            btn = gr.Button("Run")
            with gr.Accordion("Advanced options", open=False):
                if is_edge:
                    pre = gr.Radio(["Hed", "Canny", "Lineart", "No preprocess"], value="Hed",
                                   label="Preprocessor", info="Edge type.")
                    canny_low = gr.Slider(0, 255, value=100, step=50,
                                          label="Canny low threshold")
                    canny_high = gr.Slider(0, 255, value=200, step=50,
                                           label="Canny high threshold")
                else:
                    pre = gr.Radio(["Depth", "No preprocess"], value="Depth",
                                   label="Preprocessor")
                cfg = gr.Slider(0.1, 30.0, value=4.0, step=0.1, label="Guidance scale")
                strength = gr.Slider(0.0, 1.0, value=0.6, step=0.1, label="control_strength")
                top_k = gr.Slider(1, 16384, value=2000, step=1, label="Top-K")
                top_p = gr.Slider(0.0, 1.0, value=1.0, step=0.1, label="Top-P")
                temperature = gr.Slider(0.0, 2.0, value=1.0, step=0.1, label="temperature")
                seed = gr.Slider(0, 100000000, value=0, step=1, label="Seed")
                randomize = gr.Checkbox(label="Randomize seed", value=True)
        with gr.Column():
            out = gr.Image(label="generated")

    def run(image, text_val, pre_name, cfg_scale, control_strength, tk, tp, temp, sd,
            rand_sd, *canny_thresh):
        if rand_sd:
            sd = _random.randint(0, 100000000)
        # "No preprocess" keeps the tab's checkpoint and feeds the image as an
        # already rendered control map
        condition_type = {"Hed": "hed", "Canny": "canny", "Lineart": "lineart",
                          "Depth": "depth"}.get(pre_name, "hed" if is_edge else "depth")
        kw = dict(cfg_scale=cfg_scale, control_strength=control_strength, temperature=temp,
                  top_k=tk, top_p=tp, seed=int(sd), preprocess=pre_name != "No preprocess")
        if canny_thresh:
            kw["canny_low"], kw["canny_high"] = canny_thresh
        if model_type == "t2i":
            kw["prompt"] = text_val
        else:
            kw["label"] = text_val
        return engine.process(image, condition_type, **kw)

    inputs = [inp, text, pre, cfg, strength, top_k, top_p, temperature, seed, randomize]
    if is_edge:
        inputs += [canny_low, canny_high]
    btn.click(run, inputs, out)

    examples = EDGE_EXAMPLES if is_edge else DEPTH_EXAMPLES
    examples = [e for e in examples if _os.path.exists(e[0])]
    if examples and model_type == "t2i":
        gr.Examples(examples=examples, inputs=[inp, text])


def build_demo(engine: DemoEngine, model_type: str = "c2i", _gr=None):
    """The two-tab Blocks app (Depth and Edge). `_gr` takes a
    gradio-compatible module (render tests); by default gradio is imported,
    and without it the command exits pointing at the CLI."""
    gr = _gr
    if gr is None:
        try:
            import gradio as gr
        except ImportError as e:
            raise SystemExit("gradio is not installed; use the CLI "
                             "(python -m controlar_tpu_torch.cli sample-c2i / sample-t2i)"
                             ) from e
    with gr.Blocks(title="ControlAR") as demo:
        gr.Markdown(DESCRIPTION)
        with gr.Tabs():
            with gr.TabItem("Depth"):
                _create_tab(gr, engine, model_type, "depth")
            with gr.TabItem("Edge"):
                _create_tab(gr, engine, model_type, "edge")
    return demo


def main(argv=None):
    import argparse

    from controlar_tpu_torch import cli as _cli

    parser = argparse.ArgumentParser()
    _cli._add_model_args(parser)
    parser.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    parser.add_argument("--t5-path", default=None)
    parser.add_argument("--ckpt-map", default=None,
                        help="per-condition GPT ckpts: canny=a.pt,depth=b.pt")
    args = parser.parse_args(argv)

    ckpt_map = {}
    if args.ckpt_map:
        for part in args.ckpt_map.split(","):
            k, v = part.split("=", 1)
            ckpt_map[k.strip()] = v.strip()

    t5 = None
    if args.model_type == "t2i":
        from controlar_tpu_torch.text.embedder import T5Embedder

        if not args.t5_path:
            raise SystemExit("--t5-path is required for the t2i demo")
        t5 = T5Embedder.from_pretrained(args.t5_path, device=args.device)

    def factory(ct):
        return _cli._build_pipeline(argparse.Namespace(**{**vars(args), "condition_type": ct}),
                                    args.model_type)

    engine = DemoEngine(factory, ckpt_map=ckpt_map, t5=t5)
    build_demo(engine, args.model_type).launch()


if __name__ == "__main__":
    main()
