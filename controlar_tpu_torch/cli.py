"""Unified CLI: `python -m controlar_tpu_torch.cli <command>`.

The JAX package's `cli.py` with the same commands and option names, on the
port: every command runs on the card unless `--device cpu` is given (there
is no quiet move to the CPU; commands whose JAX option defaulted to the CPU
default to the card here). Commands:
    sample-c2i        class-conditional generation (+ control images, --quant,
                      class names)
    sample-t2i        text-conditional generation (T5 assets; MR via
                      --image-height/--image-width)
    train-c2i         class-conditional control training over ImageNet codes
    train-t2i         control fine-tuning over an extracted code tree
    train-vq          VQGAN tokenizer training (+ rFID smoke gate)
    serve             continuous-batching engine (--quant for int8)
    serve-warmup      build every kernel and run each admission bucket once
    quant-report      int8 / W4 accuracy against bf16
    pack-data         pack a code tree into one .car file
    extract           build code trees from image folders
    verify-zoo        released-checkpoint greedy-token parity gate
    test-consistency  generate -> re-extract -> F1/SSIM/RMSE loop
    eval-c2i          FID / sFID / IS / Precision / Recall over npz batches
    eval-t2i          CLIP score over generated images + prompts
    eval-miou         segmentation mIoU via a local reward model
    eval-vq           VQ round-trip reconstruction metrics
    sample-fid        class-balanced FID dump (images + samples.npz)
The JAX CLI's `bench` waits for the port's own benchmark.

Several cards: `torchrun --nproc_per_node N -m controlar_tpu_torch.cli
train-t2i ...` trains data-parallel over N cards (and `sample-fid` splits
its images over them); one card: plain `python -m controlar_tpu_torch.cli`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from controlar_tpu_torch import resolve_device


def _warn(msg: str) -> None:
    print(f"[warn] {msg}", file=sys.stderr)


def _add_device(p: argparse.ArgumentParser,
                help: str = "'cuda' (default; raises without a card) or 'cpu'") -> None:
    p.add_argument("--device", default="cuda", help=help)


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--gpt-model", default="GPT-XL")
    p.add_argument("--gpt-ckpt", default=None, help=".pt/.safetensors GPT weights")
    p.add_argument("--vq-ckpt", default=None, help="VQ tokenizer weights")
    p.add_argument("--adapter-ckpt", default=None, help="DINOv2/ViT weights dir or file")
    p.add_argument("--midas-ckpt", default=None,
                   help="MiDaS dpt_hybrid-midas-*.pt for depth conditioning")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--condition-type", default="canny",
                   choices=["canny", "hed", "lineart", "depth", "seg", "none"])
    p.add_argument("--adapter-size", default="small", choices=["small", "base"])
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=2000)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--control-strength", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="samples")
    p.add_argument("--quant", action="store_true",
                   help="int8 weight streaming (+ int8 KV cache where applicable)")
    p.add_argument("--spec-draft", default=None,
                   choices=["int8", "w4", "model", "model-int8"],
                   help="speculative decode (Leviathan accept/reject; "
                        "samples from the same warped target distribution "
                        "as vanilla decoding). int8/w4: quantized "
                        "self-draft; model[-int8]: the cross-size draft "
                        "from --draft-gpt-model/--draft-gpt-ckpt")
    p.add_argument("--draft-gpt-model", default=None,
                   help="smaller family member used as the speculative "
                        "draft (e.g. GPT-B drafting GPT-3B)")
    p.add_argument("--draft-gpt-ckpt", default=None,
                   help="weights for --draft-gpt-model")
    _add_device(p)


def _gpt_cfg(args, size: str, model_type: str):
    from controlar_tpu_torch.config import gpt_config

    ih = getattr(args, "image_height", None) or args.image_size
    iw = getattr(args, "image_width", None) or args.image_size
    gh, gw = ih // args.downsample_size, iw // args.downsample_size
    return gpt_config(
        size, model_type=model_type, block_size=gh * gw,
        cls_token_num=1 if model_type == "c2i" else 120,
        condition_type=args.condition_type, adapter_size=args.adapter_size,
        **({"grid_hw": (gh, gw)} if gh != gw else {}))


def _load_gpt(path, cfg, seed: int, dev, what: str):
    """A GPT from a checkpoint (fp32, the file's precision as the JAX package
    keeps it), else bf16 random weights from the seed."""
    from controlar_tpu_torch import checkpoint as ckpt_lib
    from controlar_tpu_torch.models import gpt as gpt_model

    if path:
        return ckpt_lib.load_gpt_checkpoint(path, cfg, device=dev)
    _warn(f"no --{what}: using random GPT weights")
    return gpt_model.init_gpt(cfg, seed=seed, dtype=torch.bfloat16, device=dev)


def _build_pipeline(args, model_type: str):
    """The pipeline of the model arguments: GPT, VQ and adapter from their
    checkpoints (`checkpoint.load_{gpt,vq,adapter}_checkpoint`; a native
    training checkpoint's fine-tuned adapter unless --adapter-ckpt is
    given), random weights from --seed with a warning where none is given;
    --quant quantizes the GPT to W8A16; MiDaS for depth, HED / lineart for
    their condition types (random with a warning: the JAX CLI takes no file
    for them), and the speculative draft model."""
    from controlar_tpu_torch import checkpoint as ckpt_lib
    from controlar_tpu_torch.config import vq_config
    from controlar_tpu_torch.convert_ref import load_midas_checkpoint
    from controlar_tpu_torch.models import control_nets
    from controlar_tpu_torch.models import midas as midas_model
    from controlar_tpu_torch.models import vit as vit_model
    from controlar_tpu_torch.models import vq as vq_model
    from controlar_tpu_torch.pipeline import ControlARPipeline
    from controlar_tpu_torch.quant import quantize_gpt

    dev = resolve_device(args.device)
    gcfg = _gpt_cfg(args, args.gpt_model, model_type)
    gpt = _load_gpt(args.gpt_ckpt, gcfg, args.seed, dev, "gpt-ckpt")
    if getattr(args, "quant", False):
        quantize_gpt(gpt, gcfg, "int8")

    vcfg = vq_config("VQ-16")
    if args.vq_ckpt:
        vq = ckpt_lib.load_vq_checkpoint(args.vq_ckpt, vcfg, device=dev)
    else:
        _warn("no --vq-ckpt: using random VQ weights")
        vq = vq_model.init_vq(vcfg, seed=args.seed + 1, device=dev)

    acfg = vit_model.DINOV2_SMALL if args.adapter_size == "small" else vit_model.DINOV2_BASE
    native_adapter = (args.gpt_ckpt and not args.adapter_ckpt and ckpt_lib._is_native(args.gpt_ckpt)
                      and _has_adapter(args.gpt_ckpt))
    if native_adapter:
        adapter = ckpt_lib.load_adapter_checkpoint(args.gpt_ckpt, acfg, device=dev)
    elif args.adapter_ckpt:
        adapter = ckpt_lib.load_adapter_checkpoint(args.adapter_ckpt, acfg, device=dev)
    else:
        _warn("no --adapter-ckpt: using random adapter weights")
        adapter = vit_model.init_vit(acfg, seed=args.seed + 2, device=dev)

    nets = {}
    ct = args.condition_type
    if getattr(args, "midas_ckpt", None):
        nets.update(midas=load_midas_checkpoint(args.midas_ckpt, device=dev),
                    midas_cfg=midas_model.MIDAS_HYBRID)
    elif ct == "depth":
        _warn("no --midas-ckpt: random MiDaS weights")
        nets.update(midas=midas_model.init_midas(midas_model.MIDAS_HYBRID, seed=args.seed + 4,
                                                 device=dev),
                    midas_cfg=midas_model.MIDAS_HYBRID)
    if ct in ("hed", "lineart"):
        _warn(f"random {ct} detector weights")
        init = control_nets.init_hed if ct == "hed" else control_nets.init_lineart
        nets[ct] = init(seed=args.seed + 5, device=dev)

    draft_cfg = draft = None
    if getattr(args, "draft_gpt_model", None):
        draft_cfg = _gpt_cfg(args, args.draft_gpt_model, model_type)
        draft = _load_gpt(getattr(args, "draft_gpt_ckpt", None), draft_cfg, args.seed + 3, dev,
                          "draft-gpt-ckpt")

    return ControlARPipeline(
        gpt_cfg=gcfg, gpt=gpt, vq_cfg=vcfg, vq=vq, adapter_cfg=acfg, adapter=adapter,
        condition_type=ct, device=dev, draft_gpt_cfg=draft_cfg, draft_gpt=draft, **nets)


def _has_adapter(path: str) -> bool:
    """Whether a native checkpoint carries a (fine-tuned) adapter: the JAX
    package's control state's "adapter", or the port's "adapter." names."""
    from controlar_tpu_torch import checkpoint as ckpt_lib

    tree = ckpt_lib.load_native_checkpoint(path)
    params = tree.get("ema_params") or tree.get("params") or tree
    return isinstance(params.get("adapter"), dict) or any(
        str(k).startswith("adapter.") for k in params)


def _cache_dtype(args):
    return torch.int8 if args.quant else None


def _save_images(images, out_dir: str, stem: str, ids=None) -> None:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, img in zip(ids if ids is not None else range(len(images)), images):
        Image.fromarray(img).save(os.path.join(out_dir, f"{stem}_{i}.png"))


def cmd_sample_c2i(args):
    from PIL import Image

    from controlar_tpu_torch.data.imagenet_labels import lookup_class

    pipe = _build_pipeline(args, "c2i")
    labels = np.array([lookup_class(x) for x in args.class_labels.split(",")])
    cond = None
    if args.condition_images:
        imgs = [np.asarray(Image.open(p).convert("RGB").resize((args.image_size,
                                                                args.image_size)))
                for p in args.condition_images.split(",")]
        cond = np.stack(imgs).astype(np.uint8)
        if len(imgs) == 1 and len(labels) > 1:
            cond = np.repeat(cond, len(labels), axis=0)
    out = pipe.generate(
        labels=labels, condition_images=cond, cfg_scale=args.cfg_scale,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        control_strength=args.control_strength, seed=args.seed,
        spec_draft=args.spec_draft, cache_dtype=_cache_dtype(args))
    _save_images(out, args.output_dir, "sample")
    print(f"saved {len(out)} images to {args.output_dir}")


def _train(args, model_type: str, dataset):
    """Trainer over the process group's mesh (data-parallel, as the JAX CLI's
    default TrainerConfig mesh), each rank loading its share."""
    from controlar_tpu_torch.data.loader import ShardedLoader
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(
        gpt_model=args.gpt_model, model_type=model_type, image_size=args.image_size,
        condition_type=args.condition_type, adapter_size=args.adapter_size,
        cls_token_num=1 if model_type == "c2i" else 120,
        lr=args.lr, global_batch_size=args.global_batch_size, epochs=args.epochs,
        results_dir=args.results_dir, gpt_ckpt=args.gpt_ckpt, resume_dir=args.resume_dir,
        ema=args.ema, remat_policy=args.remat_policy, opt_state_dtype=args.opt_state_dtype)
    trainer = Trainer(tcfg, device=args.device)
    index, count = trainer.batch_split()
    if args.global_batch_size % count:
        raise SystemExit(f"--global-batch-size {args.global_batch_size} does not split over "
                         f"{count} data-parallel ranks")
    loader = ShardedLoader(dataset, batch_size=args.global_batch_size // count,
                           process_index=index, process_count=count)
    return trainer.fit(loader, max_steps=args.max_steps)


def _dist_init(args) -> None:
    from controlar_tpu_torch.parallel import distributed

    # the rendezvous before any device use (torchrun / SLURM environment, or
    # the explicit flags; nothing in one process)
    distributed.init(args.dist_coordinator, args.dist_num_processes, args.dist_process_id)


def cmd_train_t2i(args):
    _dist_init(args)
    if args.code_path.endswith(".car"):
        from controlar_tpu_torch.data.carpack import CarpackControlDataset

        ds = CarpackControlDataset(args.code_path)
    else:
        from controlar_tpu_torch.data.t2i_control import (
            T2IControlCodeDataset,
            T2IControlConfig,
        )

        ds = T2IControlCodeDataset(T2IControlConfig(
            code_path=args.code_path, condition_type=args.condition_type,
            image_size=args.image_size))
    return _train(args, "t2i", ds)


def cmd_train_c2i(args):
    """Class-conditional control training over ImageNet code trees (the
    c2i branch of the one trainer)."""
    _dist_init(args)
    if args.code_dir.endswith(".car"):
        from controlar_tpu_torch.data.carpack import CarpackControlDataset

        ds = CarpackControlDataset(args.code_dir)
    else:
        if not args.label_dir:
            raise SystemExit("--label-dir is required for tree input")
        from controlar_tpu_torch.data.t2i_control import C2ICodeDataset

        ds = C2ICodeDataset(code_dir=args.code_dir, label_dir=args.label_dir,
                            condition_imgs_dir=args.condition_dir,
                            flip_aug=not args.no_flip_aug)
    return _train(args, "c2i", ds)


def _serve_gpt(args):
    """(config, GPT, serve cache dtype) of serve-warmup: bf16 weights, W8
    with the int8 cache under --quant."""
    from controlar_tpu_torch.config import gpt_config
    from controlar_tpu_torch.quant import quantize_gpt

    dev = resolve_device(args.device)
    cfg = gpt_config(args.gpt_model, model_type=args.model_type,
                     cls_token_num=1 if args.model_type == "c2i" else 120,
                     block_size=(args.image_size // args.downsample_size) ** 2,
                     vocab_size=16384, num_classes=1000)
    gpt = _load_gpt(args.gpt_ckpt, cfg, 0, dev, "gpt-ckpt").to(torch.bfloat16)
    if args.quant:
        quantize_gpt(gpt, cfg, "int8")
    return cfg, gpt, torch.int8 if args.quant else torch.bfloat16


def cmd_serve_warmup(args):
    """Deploy-time warm-up. The JAX command fills XLA's compilation cache;
    the port has no XLA: it builds every CUDA kernel into the package's
    `_build/` (on the card) and runs each admission bucket (max_slots, 4, 2,
    1 requests) through the engine once, so a server starts with its kernels
    built. --cache-dir is accepted and not used."""
    from controlar_tpu_torch import _build
    from controlar_tpu_torch.serve.engine import Request, ServeConfig, ServeEngine

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build_all()
    built_s = time.perf_counter() - t0
    cfg, gpt, cache_dtype = _serve_gpt(args)
    buckets = (tuple(int(x) for x in args.quantum_buckets.split(","))
               if args.quantum_buckets else None)
    eng = ServeEngine(gpt, cfg, ServeConfig(max_slots=args.max_slots, quantum=args.quantum,
                                            top_k=args.top_k, quantum_buckets=buckets,
                                            cache_dtype=cache_dtype), device=dev)

    def mk(i):
        if args.model_type == "c2i":
            return Request(request_id=i, label=0, cfg_scale=4.0, seed=0)
        rng = np.random.default_rng(0)
        cap = rng.standard_normal((120, cfg.caption_dim)).astype(np.float32)
        return Request(request_id=i, caption_emb=cap, emb_mask=np.ones((120,), np.int64),
                       cfg_scale=7.5)

    sizes = (args.max_slots, 4, 2, 1)
    for j, nw in enumerate(sizes):
        eng.run([mk(100 * (j + 1) + i) for i in range(min(nw, args.max_slots))])
    where = str(_build.BUILD_DIR) if dev.type == "cuda" else "nothing to build on the CPU"
    print(f"kernels: {where} ({built_s:.1f} s); ran admission buckets "
          f"{[min(n, args.max_slots) for n in sizes]}")


def cmd_quant_report(args):
    """Quantization accuracy gate (eval/quant_report.py): bf16 vs int8/W4
    teacher-forced token agreement, logit divergence, free-running prefix
    survival. Runs on --gpt-ckpt weights, or random weights for the
    systems-level bound."""
    from controlar_tpu_torch.config import gpt_config
    from controlar_tpu_torch.eval.quant_report import format_report, measure_quant_agreement

    dev = resolve_device(args.device)
    cfg = gpt_config(args.gpt_model, model_type="c2i", cls_token_num=1,
                     block_size=(args.image_size // args.downsample_size) ** 2,
                     vocab_size=16384, num_classes=1000)
    if args.gpt_ckpt:
        from controlar_tpu_torch import checkpoint as ckpt_lib

        model = ckpt_lib.load_gpt_checkpoint(args.gpt_ckpt, cfg, dtype=torch.bfloat16,
                                             device=dev)
    else:
        from controlar_tpu_torch.models import gpt as gpt_model

        _warn("no --gpt-ckpt: random weights (systems-level bound)")
        model = gpt_model.init_gpt(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    report = measure_quant_agreement(model, cfg, modes=tuple(args.modes.split(",")),
                                     max_new_tokens=args.max_new_tokens,
                                     cfg_scale=args.cfg_scale, device=dev)
    print(format_report(report))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)


def cmd_pack_data(args):
    """Pack an extracted control tree into one .car file (`data/carpack.py`):
    `train-t2i --code-path x.car` / `train-c2i --code-dir x.car` read it."""
    from controlar_tpu_torch.data.carpack import pack_control_dataset
    from controlar_tpu_torch.data.t2i_control import (
        C2ICodeDataset,
        T2IControlCodeDataset,
        T2IControlConfig,
    )

    if args.format == "t2i":
        ds = T2IControlCodeDataset(T2IControlConfig(
            code_path=args.code_path, condition_type=args.condition_type,
            image_size=args.image_size))
    else:
        ds = C2ICodeDataset(code_dir=args.code_path, label_dir=args.label_dir,
                            condition_imgs_dir=args.condition_dir)
    n = pack_control_dataset(ds, args.out, limit=args.limit)
    print(f"packed {n} records -> {args.out}")


def cmd_sample_t2i(args):
    """Text-conditional sampling: prompt -> T5 features -> control
    extraction -> CFG generate -> VQ decode."""
    from PIL import Image

    from controlar_tpu_torch.text.embedder import T5Embedder

    pipe = _build_pipeline(args, "t2i")
    if not args.t5_path:
        raise SystemExit("--t5-path (local flan-t5-xl checkout) is required")
    t5 = T5Embedder.from_pretrained(args.t5_path, device=pipe.device)
    prompts = [args.prompt or "a high-quality image"] * args.num_images
    caption_emb, emb_masks = t5.get_text_embeddings(prompts)
    cond = None
    if args.condition_image:
        ih = args.image_height or args.image_size
        iw = args.image_width or args.image_size
        img = Image.open(args.condition_image).convert("RGB").resize((iw, ih))
        cond = np.repeat(np.asarray(img, np.uint8)[None], args.num_images, 0)
    out = pipe.generate(
        caption_emb=caption_emb, emb_masks=emb_masks, condition_images=cond,
        cfg_scale=args.cfg_scale, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, control_strength=args.control_strength, seed=args.seed,
        spec_draft=args.spec_draft, cache_dtype=_cache_dtype(args))
    _save_images(out, args.output_dir, "t2i")
    print(f"saved {len(out)} images to {args.output_dir}")


def cmd_train_vq(args):
    """VQGAN tokenizer training over an image folder (`train/vq_train.py`)."""
    from controlar_tpu_torch.train.vq_train import train_vq

    train_vq(args.images, args.vq_model, args.image_size, args.batch_size, args.lr,
             args.max_steps, args.disc_start, args.disc_type, args.disc_loss,
             args.disc_adaptive_weight, args.lpips_vgg, args.lpips_lin, args.ema,
             args.log_every, args.ckpt_every, args.eval_after, args.results_dir, args.seed,
             device=args.device,
             log=lambda m: print(m, file=sys.stderr if m.startswith("[warn]") else sys.stdout,
                                 flush=True))


def cmd_serve(args):
    """Offline batch serving through the continuous-batching engine.
    --compile-cache is accepted and not used: nothing is compiled here.
    Returns (the finished requests, the engine's slot-step statistics)."""
    from controlar_tpu_torch.data.imagenet_labels import lookup_class
    from controlar_tpu_torch.models import vq as vq_model
    from controlar_tpu_torch.pipeline import to_uint8_image
    from controlar_tpu_torch.serve.engine import Request, ServeConfig, ServeEngine

    pipe = _build_pipeline(args, "c2i")  # --quant already quantized the weights
    eng = ServeEngine(pipe.gpt, pipe.gpt_cfg, ServeConfig(
        max_slots=args.max_slots, quantum=args.quantum, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        cache_dtype=torch.int8 if args.quant else torch.bfloat16), device=pipe.device)
    labels = [lookup_class(x) for x in args.class_labels.split(",")]
    reqs = [Request(request_id=i, label=lab, cfg_scale=args.cfg_scale, seed=args.seed + i)
            for i, lab in enumerate(labels)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    print(f"{len(done)} requests in {dt:.2f}s = {len(done)/dt:.2f} img/s")
    gh, gw = pipe.gpt_cfg.grid
    with torch.inference_mode():
        for r in done:
            codes = torch.as_tensor(r.tokens, device=pipe.device).reshape(1, gh, gw)
            img = to_uint8_image(vq_model.decode_code(pipe.vq, pipe.vq_cfg, codes))
            _save_images(img, args.output_dir, "serve", ids=[r.request_id])
    return done, dict(eng.stats)


def cmd_eval_vq(args):
    """VQ round-trip reconstruction metrics over a folder of images."""
    from controlar_tpu_torch.train.vq_train import eval_vq

    print(json.dumps(eval_vq(args.images, args.vq_ckpt, args.image_size, args.batch_size,
                             args.output_dir, device=args.device)))


def cmd_verify_zoo(args):
    """Released-checkpoint parity gate: each checkpoint through the imported
    torch reference and the port, greedy, PASS / FAIL on token equality."""
    from controlar_tpu_torch import verify_zoo

    results = []
    if args.self_test:
        for mt in ("c2i", "t2i"):
            results.append(verify_zoo.self_test(model_type=mt, device=args.device))
    if args.zoo_dir:
        results.extend(verify_zoo.verify_zoo_dir(
            args.zoo_dir, max_new_tokens=args.max_new_tokens or 64, device=args.device))
    for ck in args.checkpoints:
        results.append(verify_zoo.verify_checkpoint(
            ck, args.size, model_type=args.model_type, adapter_size=args.adapter_size,
            block_size=args.block_size, max_new_tokens=args.max_new_tokens,
            cfg_scale=args.cfg_scale, quant_report=args.quant_report, device=args.device))
    ok = True
    for r in results:
        print(r.line())
        ok &= r.passed
    if not ok:
        sys.exit(1)


def cmd_eval_miou(args):
    """Segmentation-consistency mIoU between generated images and ground-
    truth label maps, scored by a local reward model."""
    from PIL import Image

    from controlar_tpu_torch.eval.miou import miou_eval
    from controlar_tpu_torch.eval.segmenter import make_segmenter

    seg = make_segmenter(args.segmenter, device=args.device, label_offset=args.label_offset)
    img_fns = sorted(f for f in os.listdir(args.images) if f.endswith(".png"))

    def pairs():
        for i in range(0, len(img_fns), args.batch_size):
            chunk = img_fns[i: i + args.batch_size]
            imgs = np.stack([np.asarray(Image.open(os.path.join(args.images, f)).convert("RGB"))
                             for f in chunk])
            anns = np.stack([np.asarray(Image.open(os.path.join(args.annotations, f)))
                             for f in chunk])
            yield imgs, anns

    score = miou_eval(pairs=pairs(), segmenter=seg, num_classes=args.num_classes,
                      ignore_index=args.ignore_index)
    print(json.dumps({"miou": round(score, 5), "images": len(img_fns)}))


def cmd_sample_fid(args):
    """Class-balanced FID sample dump: N images as images/*.png and
    samples.npz, the input of `eval-c2i`. Under torchrun each data rank
    generates its share (`eval/sampler.py`), then rank 0 packs the PNGs."""
    import torch.distributed as dist

    from controlar_tpu_torch.eval.sampler import sample_c2i_fid
    from controlar_tpu_torch.parallel import distributed

    distributed.init()
    pipe = _build_pipeline(args, "c2i")
    shard = sample_c2i_fid(pipe, args.num_images, batch_size=args.batch_size,
                           cfg_scale=args.cfg_scale, top_k=args.top_k,
                           out_dir=args.output_dir, seed=args.seed, device=pipe.device)
    if dist.is_initialized():
        dist.barrier()
        if distributed.is_main_process():
            _pack_samples(args.output_dir, args.num_images)
    print(json.dumps({"generated": int(shard.shape[0]), "out": args.output_dir,
                      "rank": distributed.rank(), "ranks": distributed.world_size()}))


def _pack_samples(out_dir: str, n: int) -> None:
    """images/0.png .. images/{n-1}.png -> samples.npz (arr_0)."""
    from PIL import Image

    imgs = np.stack([np.asarray(Image.open(os.path.join(out_dir, "images", f"{i}.png")))
                     for i in range(n)])
    np.savez(os.path.join(out_dir, "samples.npz"), arr_0=imgs)


def cmd_test_consistency(args):
    """Conditional-consistency loop: generate from condition images,
    re-extract the control signal, score F1/SSIM/RMSE against the input."""
    from PIL import Image

    from controlar_tpu_torch.eval.consistency import consistency_eval

    pipe = _build_pipeline(args, "c2i")
    files = sorted(f for f in os.listdir(args.condition_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if args.max_images:
        files = files[: args.max_images]
    rng = np.random.default_rng(args.seed)

    def batches():
        for i in range(0, len(files), args.batch_size):
            chunk = files[i: i + args.batch_size]
            imgs = np.stack([
                np.asarray(Image.open(os.path.join(args.condition_dir, f)).convert("RGB")
                           .resize((args.image_size, args.image_size)))
                for f in chunk]).astype(np.uint8)
            yield {"condition_images": imgs, "labels": rng.integers(0, 1000, len(chunk))}

    kw = {}
    if args.condition_type == "depth":
        kw["depth_fn"] = pipe.depth_fn or _depth_fn(pipe)
    elif args.condition_type == "hed":
        kw["hed"] = pipe.hed
    elif args.condition_type == "lineart":
        kw["lineart"] = pipe.lineart
    score = consistency_eval(pipe, batches(), args.condition_type, cfg_scale=args.cfg_scale,
                             top_k=args.top_k, seed=args.seed, device=pipe.device, **kw)
    metric = {"canny": "f1", "hed": "ms_ssim", "lineart": "ms_ssim",
              "depth": "rmse"}[args.condition_type]
    print(json.dumps({metric: round(float(score), 5), "images": len(files)}))


def _depth_fn(pipe):
    """The pipeline's depth map (its MiDaS) as a uint8-images function."""
    from controlar_tpu_torch.models import control_nets

    def fn(imgs):
        x = torch.as_tensor(np.asarray(imgs), device=pipe.device)
        with torch.inference_mode():
            return control_nets.condition_map("depth", x, midas=pipe.midas,
                                              midas_cfg=pipe.midas_cfg).cpu().numpy()

    return fn


def cmd_eval_t2i(args):
    """t2i CLIP score over a generated-images dir + prompts file."""
    from PIL import Image

    from controlar_tpu_torch.eval.t2i_eval import clip_score

    prompts = [line.strip() for line in open(args.prompts) if line.strip()]
    files = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))[: len(prompts)]
    imgs = np.stack([np.asarray(Image.open(os.path.join(args.images, f)).convert("RGB"))
                     for f in files])
    score = clip_score(imgs, prompts[: len(files)], args.clip_model, device=args.device,
                       how_many=args.how_many)
    print(json.dumps({"clip_score": round(score, 5), "images": len(files)}))


def cmd_eval_c2i(args):
    """FID / sFID / IS / Precision / Recall between two npz image batches."""
    from controlar_tpu_torch.eval.evaluator import evaluate_all

    dev = resolve_device(args.device)
    if args.inception_ckpt:
        from controlar_tpu_torch import checkpoint as ckpt_lib

        inception = ckpt_lib.load_inception(args.inception_ckpt, device=dev)
    else:
        from controlar_tpu_torch.eval.inception import init_inception

        _warn("random Inception weights — metric values are NOT meaningful without the "
              "pytorch-fid checkpoint (pt_inception-2015-12-05-*.pth)")
        inception = init_inception(0, device=dev)
    out = evaluate_all(inception, args.ref_batch, args.sample_batch,
                       batch_size=args.batch_size, device=dev)
    print(json.dumps({k: round(float(v), 5) for k, v in out.items()}))


def cmd_extract(args):
    """Build a code tree from an image folder (+ optional captions jsonl)."""
    from PIL import Image

    from controlar_tpu_torch import checkpoint as ckpt_lib
    from controlar_tpu_torch.config import vq_config
    from controlar_tpu_torch.data.extract import extract_c2i_tree, extract_tree
    from controlar_tpu_torch.models import vq as vq_model

    dev = resolve_device(args.device)
    vcfg = vq_config("VQ-16")
    if args.vq_ckpt:
        vq = ckpt_lib.load_vq_checkpoint(args.vq_ckpt, vcfg, device=dev)
    else:
        _warn("random VQ weights")
        vq = vq_model.init_vq(vcfg, seed=0, device=dev)

    if args.task == "c2i":
        conditions = tuple(c for c in args.conditions.split(",") if c)
        midas = midas_cfg = None
        if "depth" in conditions:
            from controlar_tpu_torch.models import midas as midas_model

            midas_cfg = midas_model.MIDAS_HYBRID
            if args.midas_ckpt:
                from controlar_tpu_torch.convert_ref import load_midas_checkpoint

                midas = load_midas_checkpoint(args.midas_ckpt, device=dev)
            else:
                _warn("random MiDaS weights")
                midas = midas_model.init_midas(midas_cfg, seed=1, device=dev)

        def c2i_samples():
            classes = sorted(d for d in os.listdir(args.images)
                             if os.path.isdir(os.path.join(args.images, d)))
            if classes:  # ImageNet-style class subfolders
                for label, cls in enumerate(classes):
                    cdir = os.path.join(args.images, cls)
                    for f in sorted(os.listdir(cdir)):
                        if f.lower().endswith((".png", ".jpg", ".jpeg")):
                            yield {"image": Image.open(os.path.join(cdir, f)), "label": label}
            else:  # flat folder, label 0
                for f in sorted(os.listdir(args.images)):
                    if f.lower().endswith((".png", ".jpg", ".jpeg")):
                        yield {"image": Image.open(os.path.join(args.images, f)), "label": 0}

        n = extract_c2i_tree(
            args.output_dir, c2i_samples(), vq, vcfg, dataset=args.dataset,
            image_size=args.image_size, use_ten_crop=args.ten_crop, crop_range=args.crop_range,
            conditions=conditions, canny_low=args.min_threshold, canny_high=args.max_threshold,
            midas=midas, midas_cfg=midas_cfg, batch_images=args.batch_images, device=dev)
        print(f"extracted {n} c2i samples to {args.output_dir}")
        return

    captions = {}
    if args.captions:
        for line in open(args.captions):
            rec = json.loads(line)
            captions[rec["image"]] = rec["caption"]
    t5 = None
    if args.t5_path:
        from controlar_tpu_torch.text.embedder import T5Embedder

        t5 = T5Embedder.from_pretrained(args.t5_path, device=dev)

    def samples():
        for f in sorted(os.listdir(args.images)):
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                yield {"image": Image.open(os.path.join(args.images, f)),
                       "caption": captions.get(f, "")}

    n = extract_tree(args.output_dir, samples(), vq, vcfg, t5_embedder=t5,
                     image_size=args.image_size, device=dev)
    print(f"extracted {n} samples to {args.output_dir}")


def _add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--global-batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--results-dir", default="results")
    p.add_argument("--resume-dir", default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "qkv", "attn", "qkv_attn", "dots", "none"])
    p.add_argument("--opt-state-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="Adam moment storage; bfloat16 halves the optimizer's memory")
    p.add_argument("--dist-coordinator", default=None,
                   help="rendezvous address host:port (torchrun and SLURM set it "
                        "themselves)")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="controlar_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("sample-c2i")
    _add_model_args(p)
    p.add_argument("--class-labels", default="207,360,387,974",
                   help="comma-separated class ids or names (e.g. 'golden retriever')")
    p.add_argument("--condition-images", default=None, help="comma-separated paths")
    p.set_defaults(fn=cmd_sample_c2i)

    p = sub.add_parser("train-t2i")
    _add_model_args(p)
    p.add_argument("--code-path", required=True)
    _add_train_args(p)
    p.set_defaults(fn=cmd_train_t2i)

    p = sub.add_parser("serve-warmup", help=cmd_serve_warmup.__doc__.split("\n")[0])
    _add_model_args(p)
    p.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--quantum", type=int, default=72)
    p.add_argument("--quantum-buckets", default=None, help="comma list, e.g. 72,36,18")
    p.add_argument("--cache-dir", default=None,
                   help="accepted and not used: the port builds its CUDA kernels into the "
                        "package's _build/ directory (there is no XLA cache)")
    p.set_defaults(fn=cmd_serve_warmup)

    p = sub.add_parser("quant-report")
    _add_model_args(p)
    p.add_argument("--modes", default="int8,int8+kv8,w4,w4+kv8")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--json-out", default=None)
    p.set_defaults(fn=cmd_quant_report)

    p = sub.add_parser("pack-data")
    p.add_argument("--format", choices=["t2i", "c2i"], default="t2i")
    p.add_argument("--code-path", required=True,
                   help="extracted tree root (t2i) or codes dir (c2i)")
    p.add_argument("--label-dir", default=None, help="c2i labels dir")
    p.add_argument("--condition-dir", default=None)
    p.add_argument("--condition-type", default="canny")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", required=True, help="output .car path")
    _add_device(p, "accepted for every command; packing runs on the host")
    p.set_defaults(fn=cmd_pack_data)

    p = sub.add_parser("train-c2i")
    _add_model_args(p)
    p.add_argument("--code-dir", required=True, help="imagenet{S}_codes dir")
    p.add_argument("--label-dir", default=None,
                   help="imagenet{S}_labels dir (not needed for .car input)")
    p.add_argument("--condition-dir", default=None,
                   help="imagenet{S}_<cond>_imagesnpy dir (None: extraction on the device "
                        "from control images in the batch)")
    p.add_argument("--no-flip-aug", action="store_true")
    _add_train_args(p)
    p.set_defaults(fn=cmd_train_c2i)

    p = sub.add_parser("sample-t2i")
    p.add_argument("--image-height", type=int, default=None,
                   help="MR: explicit output height (pairs with --image-width; exact "
                        "rectangular RoPE)")
    p.add_argument("--image-width", type=int, default=None)
    _add_model_args(p)
    p.add_argument("--prompt", default=None)
    p.add_argument("--t5-path", default=None)
    p.add_argument("--condition-image", default=None)
    p.add_argument("--num-images", type=int, default=4)
    p.set_defaults(fn=cmd_sample_t2i)

    p = sub.add_parser("train-vq")
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--images", required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--disc-start", type=int, default=20000)
    p.add_argument("--disc-type", default="patchgan", choices=["patchgan", "stylegan"])
    p.add_argument("--disc-loss", default="hinge",
                   choices=["hinge", "vanilla", "non-saturating"])
    p.add_argument("--disc-adaptive-weight", action="store_true",
                   help="grad-norm-ratio adaptive disc weight")
    p.add_argument("--lpips-vgg", default=None)
    p.add_argument("--lpips-lin", default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--eval-after", type=int, default=64,
                   help="run the reconstruction rFID smoke gate on this many images after "
                        "training (0 disables)")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    _add_device(p)
    p.set_defaults(fn=cmd_train_vq)

    p = sub.add_parser("serve")
    p.add_argument("--compile-cache", default=None,
                   help="accepted and not used: the port compiles nothing at serve time")
    _add_model_args(p)
    p.add_argument("--class-labels", default="207,360,387,974,88,979,417,279")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--quantum", type=int, default=64)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("eval-vq")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--images", required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--output-dir", default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_vq)

    p = sub.add_parser("verify-zoo")
    p.add_argument("checkpoints", nargs="*", help=".pt/.safetensors paths")
    p.add_argument("--size", default="GPT-XL")
    p.add_argument("--model-type", default="t2i", choices=["c2i", "t2i"])
    p.add_argument("--adapter-size", default="small", choices=["small", "base"])
    p.add_argument("--block-size", type=int, default=1024,
                   help="image tokens (1024 = 512px t2i, 576 = 384px c2i)")
    p.add_argument("--max-new-tokens", type=int, default=None,
                   help="cap decode steps (full block by default)")
    p.add_argument("--cfg-scale", type=float, default=2.0)
    p.add_argument("--self-test", action="store_true",
                   help="run the gate on a tiny random reference checkpoint")
    p.add_argument("--quant-report", action="store_true",
                   help="also measure int8/W4 serving-mode token agreement against the "
                        "converted weights (c2i)")
    p.add_argument("--zoo-dir", default=None,
                   help="gate every released zoo file found in this dir")
    _add_device(p)
    p.set_defaults(fn=cmd_verify_zoo)

    p = sub.add_parser("eval-miou")
    p.add_argument("--images", required=True, help="generated images dir")
    p.add_argument("--annotations", required=True, help="gt label maps dir")
    p.add_argument("--segmenter", required=True,
                   help="local transformers seg checkpoint dir, or an mmseg .pth")
    p.add_argument("--num-classes", type=int, default=151,
                   help="label bins incl. the offset (ADE20K: 151)")
    p.add_argument("--ignore-index", type=int, default=0)
    p.add_argument("--label-offset", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_miou)

    p = sub.add_parser("sample-fid")
    _add_model_args(p)
    p.add_argument("--num-images", type=int, default=50000)
    p.add_argument("--batch-size", type=int, default=8)
    p.set_defaults(fn=cmd_sample_fid)

    p = sub.add_parser("test-consistency")
    _add_model_args(p)
    p.add_argument("--condition-dir", required=True,
                   help="directory of condition source images")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.set_defaults(fn=cmd_test_consistency)

    p = sub.add_parser("eval-t2i")
    p.add_argument("--images", required=True)
    p.add_argument("--prompts", required=True, help="one prompt per line")
    p.add_argument("--clip-model", required=True,
                   help="local transformers CLIP dir (clip-vit-base-patch32)")
    p.add_argument("--how-many", type=int, default=5000)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_t2i)

    p = sub.add_parser("eval-c2i")
    p.add_argument("ref_batch", help="reference npz (arr_0 NHWC uint8, or mu/sigma stats)")
    p.add_argument("sample_batch", help="samples npz from eval/sampler.py")
    p.add_argument("--inception-ckpt", default=None,
                   help="pytorch-fid pt_inception-2015-12-05-*.pth")
    p.add_argument("--batch-size", type=int, default=64)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_c2i)

    p = sub.add_parser("extract")
    p.add_argument("--task", default="t2i", choices=["t2i", "c2i"],
                   help="t2i: code/caption_emb/image tree; c2i: ImageNet "
                        "{codes,labels,cond_imagesnpy} trees")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--t5-path", default=None)
    p.add_argument("--images", required=True,
                   help="image folder; for c2i, an ImageNet-style class-subfolder tree "
                        "(label = sorted folder index)")
    p.add_argument("--captions", default=None, help="jsonl with image/caption")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--dataset", default="imagenet", help="c2i tree prefix")
    p.add_argument("--ten-crop", action="store_true",
                   help="c2i: 10 crops/image instead of center+flip")
    p.add_argument("--crop-range", type=float, default=1.1)
    p.add_argument("--conditions", default="", help="c2i: comma subset of canny,depth")
    p.add_argument("--min-threshold", type=int, default=100)
    p.add_argument("--max-threshold", type=int, default=200)
    p.add_argument("--midas-ckpt", default=None,
                   help="MiDaS dpt_hybrid checkpoint for depth extraction")
    p.add_argument("--batch-images", type=int, default=8)
    _add_device(p)
    p.set_defaults(fn=cmd_extract)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
