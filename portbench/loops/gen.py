"""Offline sampling: a closed loop of `ControlARPipeline.generate` calls.
The window counts every image token generated in it; the check
teacher-forces a sample of the rows of the window's first greedy call
through the reference and decodes their tokens with the reference's
tokenizer."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from portbench.harness import check as chk
from portbench.harness import program, traffic as tr
from portbench.harness.loops import Base, WindowEnd, free_device, reference_features, sync
from portbench.harness.trace import Slice, span, spanned
from portbench.reference import exact_fp32
from portbench.reference import gpt as ref_gpt
from portbench.reference import vq as ref_vq


class Loop(Base):
    """Closed-loop batch generation: back-to-back `generate` calls of
    traffic["batch"] images; call i is greedy (temperature 0) when
    i % greedy_every == 0, else sampled at the configuration's temperature."""

    def setup(self, seconds: float) -> None:
        from controlar_tpu_torch import generate as tgen
        from controlar_tpu_torch.models import vq as vq_model
        from controlar_tpu_torch.pipeline import to_uint8_image

        t, g, dev = self.traffic, self.g, self.device
        self.pipe = program.build_pipeline(self.cfg, self.seed, dev)
        self.extra = program.lower_precision(self.pipe, self.cfg) if self.control \
            else program.generate_options(self.cfg)
        self.b = t["batch"]
        self.calls = [self._inputs(i) for i in range(t["max_calls"])]
        # spans around each call into a layer, and the tokens each call hands
        # the tokenizer (kept for the check)
        self.captured: List[torch.Tensor] = []
        self._orig = (tgen.generate, vq_model.decode_code)

        def tokens(*a, **k):
            out = self._orig[0](*a, **k)
            self.captured.append(out)
            return out

        tgen.generate = spanned("tokens", tokens)
        vq_model.decode_code = spanned("vq_decode", self._orig[1])
        self.pipe.extract_condition = spanned("condition", self.pipe.extract_condition)
        self.pipe.control_features = spanned("adapter", self.pipe.control_features)
        # warm-up: a call of the window's shapes stopped after warm_steps, and
        # one tokenizer decode of the batch
        warm = self._inputs("warm")
        self._run(warm, False, stop_after=t["warm_steps"])
        gh, gw = g["grid"]
        codes = torch.randint(0, self.cfg["vq"]["codebook_size"], (self.b, gh, gw), device=dev)
        to_uint8_image(vq_model.decode_code(self.pipe.vq, self.pipe.vq_cfg, codes))
        self.captured.clear()
        sync(dev)

    def _inputs(self, i) -> dict:
        t, g = self.traffic, self.g
        px = self.cfg["image_px"]
        s = self.cfg["sampling"]
        kw = dict(condition_images=tr.condition_images(self.b, px, self.seed, "gen", i),
                  cfg_scale=s["cfg_scale"], top_k=s["top_k"],
                  seed=tr.torch_seed(self.seed, "gen_call", i))
        if g["model_type"] == "c2i":
            kw["labels"] = tr.labels(self.b, g["num_classes"], self.seed, "gen", i)
        else:
            kw["caption_emb"], mask = tr.captions(self.b, g, t["caption_min"], t["caption_max"],
                                                  self.seed, self.device, "gen", i)
            kw["emb_masks"] = torch.as_tensor(mask, device=self.device)
        return kw

    def _run(self, inputs: dict, greedy: bool, stop_after: Optional[int] = None, deadline=None,
             timings: Optional[dict] = None, hook=None):
        """One generate call, greedy (temperature 0) or at the configuration's
        temperature; -> (images or None if stopped, tokens per row)."""
        done = [0]

        def on_step(i):
            done[0] = i + 1
            if hook is not None:
                hook(i)
            if (stop_after is not None and i + 1 >= stop_after) or \
                    (deadline is not None and time.perf_counter() >= deadline):
                raise WindowEnd

        temperature = 0.0 if greedy else self.cfg["sampling"]["temperature"]
        try:
            imgs = self.pipe.generate(**inputs, **self.extra, temperature=temperature,
                                      on_step=on_step, timings=timings)
        except WindowEnd:
            return None, 1 + done[0]
        return imgs, self.g["block_size"]

    def window(self, seconds: float) -> dict:
        dev = self.device
        sync(dev)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        calls, i = [], 0
        while time.perf_counter() < deadline:
            timings = {} if self.trace else None
            greedy = i % self.traffic["greedy_every"] == 0
            imgs, n = self._run(self.calls[i % len(self.calls)], greedy, deadline=deadline,
                                timings=timings)
            calls.append({"index": i, "greedy": greedy, "tokens_per_row": n,
                          "complete": imgs is not None, "stages": timings, "images": imgs})
            i += 1
        sync(dev)
        seconds_run = time.perf_counter() - t0
        facts = {"kind": "gen", "seconds": seconds_run, "batch": self.b,
                 "tokens_per_image": self.g["block_size"],
                 "tokens": sum(c["tokens_per_row"] * self.b for c in calls),
                 "calls": [{k: v for k, v in c.items() if k != "images"} for c in calls]}
        # the check's call: the first greedy call whole in the window, its
        # tokens as the tokenizer got them; if the window closed inside the
        # first greedy call, that call runs again whole after it, for the
        # check alone
        whole = [c for c in calls if c["complete"]]
        tokens = dict(zip([c["index"] for c in whole], self.captured))
        first = next((c for c in whole if c["greedy"]), None)
        if first is None:
            imgs, _ = self._run(self.calls[0], True)
            first = {"index": 0, "images": imgs}
            tokens[0] = self.captured[-1]
        self.check_call = (first["index"], first["images"], tokens[first["index"]])
        self.n_attempted = len(calls) * self.b
        return facts

    def trace_slice(self, steps: int, save=None) -> dict:
        """`steps` decode steps from the middle of a call, profiled."""
        start = self.g["block_size"] // 2
        state = {}

        def hook(i):
            if i == start - 1:
                state["slice"] = Slice(self.device, save).__enter__()
                state["span"] = span("decode_step").__enter__()
            elif "slice" in state and i < start + steps:
                state["span"].__exit__(None, None, None)
                if i == start + steps - 1:
                    state["slice"].__exit__(None, None, None)
                    raise WindowEnd
                state["span"] = span("decode_step").__enter__()

        self._run(self.calls[1 % len(self.calls)], False, hook=hook)
        cls = self.g["cls_token_num"]
        return {**state["slice"].summary, "kind": "gen", "rows": 2 * self.b,
                "live_rows": [cls + i + 1 for i in range(start, start + steps)],
                "bias": self.g["model_type"] == "t2i"}

    def free(self) -> None:
        from controlar_tpu_torch import generate as tgen
        from controlar_tpu_torch.models import vq as vq_model

        tgen.generate, vq_model.decode_code = self._orig
        self.pipe = None
        free_device(self.device)

    def check(self, limits: dict) -> Tuple[List[chk.Number], int, int]:
        """The first greedy call that completed in the window: a sample of
        its rows teacher-forced through the reference."""
        exact_fp32()
        t, g, dev = self.traffic, self.g, self.device
        index, images, tokens = self.check_call
        inputs = self.calls[index % len(self.calls)]
        rows = np.sort(tr.rng(self.seed, "check_rows").choice(self.b, min(self.b, t["check_rows"]),
                                                              replace=False))
        w = program.reference_weights(self.cfg, self.seed, dev)
        with torch.no_grad():
            feats = reference_features(w["adapter"], self.cfg, inputs["condition_images"][rows],
                                        dev)
            kw, sel = {}, torch.as_tensor(rows, device=dev)
            if g["model_type"] == "c2i":
                kw["labels"] = torch.as_tensor(inputs["labels"], device=dev)[sel]
            else:
                kw["caption"] = inputs["caption_emb"][sel].float()
                kw["caption_mask"] = inputs["emb_masks"][sel].bool()
            toks = tokens[torch.as_tensor(rows, device=tokens.device)].to(dev)
            gaps = []
            for r in range(len(rows)):  # a row at a time: [cond; uncond] of one image
                one = {k: v[r: r + 1] for k, v in kw.items()}
                logits = ref_gpt.cfg_logits(w["gpt"], g, toks[r: r + 1],
                                            self.cfg["sampling"]["cfg_scale"],
                                            feats=feats[r: r + 1], **one)
                gaps.append(chk.logit_gaps(logits[0], toks[r]))
            del w["gpt"]
            gh, gw = g["grid"]
            err = 0.0
            for r in range(len(rows)):
                pix = ref_vq.to_pixels(ref_vq.decode_codes(w["vq"], self.cfg["vq"],
                                                           toks[r: r + 1].reshape(1, gh, gw)))
                got = torch.as_tensor(images[rows[r]], device=dev)
                err = max(err, chk.pixel_err(got, pix[0]))
        return [chk.gap_number(gaps, limits),
                ("pixel_err", err, limits.get("pixel_err", 0.0))], self.n_attempted, 0
