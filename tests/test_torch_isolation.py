"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never drift to the CPU on their own."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import spec_decode as tspec
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq
from controlar_tpu_torch.pipeline import ControlARPipeline
from controlar_tpu_torch.serve import Request, ServeConfig, ServeEngine
from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "controlar_tpu_torch"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import controlar_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'controlar_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'controlar_tpu' or m.startswith('controlar_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 12 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
                         + ["ab_phases.py", "chip_smoke.py"])
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    assert "controlar_tpu." not in text
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)


def _tiny():
    cfg = GPTConfig(model_type="c2i", dim=32, n_layer=3, n_head=2, vocab_size=16,
                    num_classes=4, block_size=4)
    return cfg, tgpt.init_gpt(cfg, seed=0)


def test_generate_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg, model = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        tgen.generate(model, cfg, labels=torch.tensor([1]), max_new_tokens=2)
    toks = tgen.generate(model, cfg, labels=torch.tensor([1]), max_new_tokens=2, device="cpu")
    assert toks.shape == (1, 2)


def test_generate_spec_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg, model = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        tspec.generate_spec(model, cfg, model, labels=torch.tensor([1]), max_new_tokens=2)
    toks = tspec.generate_spec(model, cfg, model, labels=torch.tensor([1]), max_new_tokens=2,
                               device="cpu")
    assert toks.shape == (1, 2)


def test_pipeline_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg, model = _tiny()
    vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, decoder_ch_mult=(1, 1))
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, pos_grid=2)
    mods = dict(gpt_cfg=cfg, gpt=model, vq_cfg=vcfg, vq=tvq.init_vq(vcfg),
                adapter_cfg=acfg, adapter=tvit.init_vit(acfg))
    with pytest.raises(RuntimeError, match="cuda"):
        ControlARPipeline(**mods)
    pipe = ControlARPipeline(**mods, device="cpu")
    out = pipe.generate(labels=np.array([2]), top_k=4)
    assert out.shape == (1, 4, 4, 3) and out.dtype == np.uint8
    with pytest.raises(ValueError, match="expected cpu"):  # the draft is on the pipeline's device
        ControlARPipeline(**mods, device="cpu", draft_gpt_cfg=cfg,
                          draft_gpt=tgpt.init_gpt(cfg).to("meta"))


def test_serve_engine_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg, model = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(model, cfg)
    eng = ServeEngine(model, cfg, ServeConfig(max_slots=2, quantum=3, top_k=4), device="cpu")
    done = eng.run([Request(request_id=i, label=i, seed=i) for i in range(3)])
    assert [r.tokens.shape for r in done] == [(4,)] * 3
    with pytest.raises(ValueError):
        ServeEngine(model, cfg, device="meta")


def test_model_on_another_device_is_refused():
    cfg, model = _tiny()
    with pytest.raises(ValueError):
        tgen.generate(model, cfg, labels=torch.tensor([1]), max_new_tokens=2,
                      device="meta")


def test_trainer_raises_without_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tcfg = TrainerConfig(gpt_model="GPT-B", image_size=64, cls_token_num=8,
                         results_dir=str(tmp_path),
                         model_overrides=dict(dim=64, n_layer=3, n_head=2, vocab_size=64,
                                              caption_dim=32),
                         adapter_override=tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2,
                                                         pos_grid=4))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tcfg)
    state = Trainer(tcfg, device="cpu").init_state()
    assert state.step == 0 and all(p.device.type == "cpu" for p in state.params.values())
    with pytest.raises(NotImplementedError, match="mesh"):  # one card until parallel/ is ported
        Trainer(TrainerConfig(**{**tcfg.__dict__, "fsdp_axis": 2}), device="cpu")


# packages the card's machine does not have
ABSENT_ON_THE_CARD = ("transformers", "timm", "cv2", "safetensors", "ml_dtypes", "orbax", "bs4",
                      "sentencepiece", "ftfy", "diffusers", "cleanfid")
# the only imports of those allowed, inside a function that the card's runs
# never call: HF's tokenizer when the caller gives none, ftfy's optional
# mojibake repair, the transformers segmenters, Mask2Former and CLIP, the
# cleanfid wrapper, the diffusers autoencoders
OPTIONAL_IMPORTS = {"text/embedder.py": ("transformers",), "text/cleaning.py": ("ftfy",),
                    "eval/segmenter.py": ("transformers",),
                    "eval/t2i_eval.py": ("transformers", "cleanfid"),
                    "convert_mmseg.py": ("transformers",),
                    "models/latent_vae.py": ("diffusers",)}


def test_port_imports_no_transformers_timm_or_cv2():
    """The card's machine has none of ABSENT_ON_THE_CARD (transformers, timm,
    cv2, safetensors, ml_dtypes, orbax, bs4, sentencepiece, ftfy, diffusers,
    cleanfid): no module of the port names one, but OPTIONAL_IMPORTS inside
    a function, and importing every module loads none (nor JAX or the JAX
    package)."""
    names = "|".join(ABSENT_ON_THE_CARD)
    for path in sorted(PKG.rglob("*.py")):
        allowed = OPTIONAL_IMPORTS.get(str(path.relative_to(PKG)), ())
        for m in re.finditer(rf"^(\s*)(import|from)\s+({names})\b", path.read_text(), re.M):
            assert m.group(1) and m.group(3) in allowed, (path, m.group(0))
    code = (
        "import importlib, pkgutil, sys\n"
        "import controlar_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'controlar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"absent = {ABSENT_ON_THE_CARD + ('jax', 'controlar_tpu')!r}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in absent)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# the condition networks' builders and loaders, the SSIM metric and the
# consistency evaluation: name -> call(**device_kw); the loaders get an empty
# state dict, so only their refusal is checked here
CONDITION_ENTRY_POINTS = ("init_hed", "init_lineart", "init_dpt", "init_midas",
                          "hed_from_state_dict", "lineart_from_state_dict",
                          "dpt_from_state_dict", "midas_from_state_dict", "SSIM",
                          "reextract", "consistency_eval")


def _condition_call(name):
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.eval import consistency, metrics
    from controlar_tpu_torch.models import control_nets, dpt, midas

    if name == "init_hed":
        return lambda **d: control_nets.init_hed(channels=(4, 4, 4, 4, 4), **d)
    if name == "init_lineart":
        return lambda **d: control_nets.init_lineart(ngf=4, **d)
    if name == "init_dpt":
        return lambda **d: dpt.init_dpt(dpt.DPTConfig(
            hidden_size=32, n_layer=1, n_head=2, mlp_dim=64, out_indices=(0,),
            neck_hidden_sizes=(8,), reassemble_factors=(1,), fusion_hidden_size=8), **d)
    if name == "init_midas":
        return lambda **d: midas.init_midas(midas.MidasHybridConfig(
            stem_width=32, layers=(1, 1, 1), hidden_size=32, n_layer=1, n_head=2, mlp_dim=64,
            vit_hooks=(0, 0), features=16, layer_channels=(256, 512, 32, 32)), **d)
    if name.endswith("_from_state_dict"):
        return lambda **d: getattr(convert_ref, name)({}, **d)
    if name == "SSIM":
        return lambda **d: metrics.SSIM(**d)
    if name == "reextract":
        return lambda **d: consistency.reextract("canny", np.zeros((1, 16, 16, 3), np.uint8),
                                                 **d)
    cfg, model = _tiny()
    vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, decoder_ch_mult=(1, 1))
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, pos_grid=2)
    pipe = ControlARPipeline(gpt_cfg=cfg, gpt=model, vq_cfg=vcfg, vq=tvq.init_vq(vcfg),
                             adapter_cfg=acfg, adapter=tvit.init_vit(acfg), device="cpu")
    return lambda **d: consistency.consistency_eval(pipe, [], "canny", **d)


@pytest.mark.parametrize("name", CONDITION_ENTRY_POINTS)
def test_condition_entry_points_raise_without_a_card_unless_cpu_is_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    call = _condition_call(name)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    if not name.endswith("_from_state_dict"):
        out = call(device="cpu")
        if isinstance(out, torch.nn.Module):
            assert all(p.device.type == "cpu" and not p.requires_grad
                       for p in out.parameters())


# the loaders of released and native weights, the quant report, the toy
# training and the VQ encode: name -> call(tmp_path, **device_kw)
SLICE8_ENTRY_POINTS = ("load_gpt_checkpoint", "load_vq_checkpoint", "load_adapter_checkpoint",
                       "gpt_from_state_dict", "vq_from_state_dict", "vit_from_hf_state_dict",
                       "measure_quant_agreement", "toy_train", "toy_train_main", "vq_encode")


def _slice8_call(name, tmp_path):
    from controlar_tpu_torch import checkpoint, convert_ref, toy_train
    from controlar_tpu_torch.eval.quant_report import measure_quant_agreement

    cfg, model = _tiny()
    vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, encoder_ch_mult=(1, 1),
                    decoder_ch_mult=(1, 1))
    acfg = tvit.ViTConfig(hidden_size=32, n_layer=1, n_head=2, pos_grid=2)
    vq = tvq.init_vq(vcfg)
    files = {"gpt": convert_ref.gpt_reference_state_dict(model),
             "vq": convert_ref.vq_reference_state_dict(vq),
             "adapter": convert_ref.vit_hf_state_dict(tvit.init_vit(acfg), acfg)}
    for k, sd in files.items():
        checkpoint.save_safetensors(sd, str(tmp_path / f"{k}.safetensors"))
    if name == "load_gpt_checkpoint":
        return lambda **d: checkpoint.load_gpt_checkpoint(str(tmp_path / "gpt.safetensors"), cfg,
                                                          **d)
    if name == "load_vq_checkpoint":
        return lambda **d: checkpoint.load_vq_checkpoint(str(tmp_path / "vq.safetensors"), vcfg,
                                                         **d)
    if name == "load_adapter_checkpoint":
        return lambda **d: checkpoint.load_adapter_checkpoint(
            str(tmp_path / "adapter.safetensors"), acfg, **d)
    if name == "gpt_from_state_dict":
        return lambda **d: convert_ref.gpt_from_state_dict(files["gpt"], cfg, **d)
    if name == "vq_from_state_dict":
        return lambda **d: convert_ref.vq_from_state_dict(files["vq"], vcfg, **d)
    if name == "vit_from_hf_state_dict":
        return lambda **d: convert_ref.vit_from_hf_state_dict(files["adapter"], acfg, **d)
    if name == "measure_quant_agreement":
        return lambda **d: measure_quant_agreement(model, cfg, modes=("int8",),
                                                   max_new_tokens=4, **d)
    if name == "toy_train":
        return lambda **d: toy_train.train(cfg, steps=1, batch=2, num_classes_used=4,
                                           log=lambda m: None, **d)
    if name == "toy_train_main":
        return lambda **d: toy_train.main(["--size", "GPT-B", "--steps", "0"]
                                          + [f"--device={v}" for v in d.values()])
    return lambda **d: tvq.encode(vq, vcfg, torch.zeros(1, 4, 4, 3), **d)


@pytest.mark.parametrize("name", SLICE8_ENTRY_POINTS)
def test_slice8_entry_points_raise_without_a_card_unless_cpu_is_asked(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    call = _slice8_call(name, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    if name == "toy_train_main":  # its CPU run is tests/test_torch_toy_train.py's
        return
    out = call(device="cpu")
    modules = [out] if isinstance(out, torch.nn.Module) else [out["model"]] if name == "toy_train" \
        else []
    for m in modules:
        assert all(p.device.type == "cpu" and not p.requires_grad for p in m.parameters())


# the text encoder, its loaders, the embedder and the extraction:
# name -> call(tmp_path, **device_kw)
SLICE11_ENTRY_POINTS = ("init_t5", "t5_from_state_dict", "load_t5_encoder", "T5Embedder",
                        "T5Embedder.from_pretrained", "extract_tree", "extract_c2i_tree")


def _slice11_call(name, tmp_path):
    from controlar_tpu_torch import checkpoint, convert_ref
    from controlar_tpu_torch.data import extract
    from controlar_tpu_torch.models import t5
    from controlar_tpu_torch.text.embedder import T5Embedder

    tcfg = t5.T5Config(vocab_size=32, d_model=16, d_kv=4, d_ff=24, n_layer=1, n_head=2)
    sd = convert_ref.t5_hf_state_dict(t5.init_t5(tcfg, device="cpu"))
    checkpoint.save_safetensors(sd, str(tmp_path / "model.safetensors"))
    tok = lambda texts, n: (np.ones((len(texts), n), np.int64),) * 2  # noqa: E731
    vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, encoder_ch_mult=(1, 1),
                    decoder_ch_mult=(1, 1))
    image = np.zeros((16, 16, 3), np.uint8)
    if name == "init_t5":
        return lambda **d: t5.init_t5(tcfg, **d)
    if name == "t5_from_state_dict":
        return lambda **d: convert_ref.t5_from_state_dict(sd, tcfg, **d)
    if name == "load_t5_encoder":
        return lambda **d: checkpoint.load_t5_encoder(str(tmp_path), tcfg, **d)
    if name == "T5Embedder":
        return lambda **d: T5Embedder(t5.init_t5(tcfg, device="cpu"), tok, tcfg, 4, **d)
    if name == "T5Embedder.from_pretrained":
        return lambda **d: T5Embedder.from_pretrained(str(tmp_path), tok, tcfg, **d,
                                                      model_max_length=4)
    vq = tvq.init_vq(vcfg)
    if name == "extract_tree":
        return lambda **d: extract.extract_tree(str(tmp_path / "tree"), [{"image": image}], vq,
                                                vcfg, image_size=16, **d)
    return lambda **d: extract.extract_c2i_tree(str(tmp_path / "c2i"),
                                                [{"image": image, "label": 1}], vq, vcfg,
                                                image_size=8, **d)


@pytest.mark.parametrize("name", SLICE11_ENTRY_POINTS)
def test_slice11_entry_points_raise_without_a_card_unless_cpu_is_asked(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    call = _slice11_call(name, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    out = call(device="cpu")
    if name.startswith("T5Embedder"):
        assert out.device.type == "cpu"
        emb, mask = out.get_text_embeddings(["a caption"])
        assert emb.shape == (1, 4, 16) and emb.device.type == "cpu"
        out = out.model
    if isinstance(out, torch.nn.Module):
        assert all(p.device.type == "cpu" and not p.requires_grad for p in out.parameters())
    else:
        assert out == 1  # one sample written


# tokenizer and multiscale training (slice 9): each module imported alone
SLICE9_MODULES = ("models.lpips", "models.discriminators", "train.vq_loss", "train.vq_step",
                  "train.vq_train", "train.multiscale", "eval.reconstruction",
                  "train.optimizer")


def test_slice9_modules_load_no_jax_optax_or_the_jax_package():
    """Each module of the slice, imported in a fresh interpreter, loads no
    jax, optax or controlar_tpu."""
    code = (
        "import importlib, sys\n"
        "importlib.import_module('controlar_tpu_torch.' + sys.argv[1])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'controlar_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in SLICE9_MODULES:
        res = subprocess.run([sys.executable, "-c", code, name], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, (name, res.stdout + res.stderr)


SLICE9_ENTRY_POINTS = ("init_lpips", "init_patchgan", "init_stylegan_disc",
                       "lpips_from_state_dicts", "patchgan_from_state_dict",
                       "stylegan_disc_from_state_dict", "train_vq", "eval_vq",
                       "reconstruction_eval", "multiscale_step")


def _slice9_call(name, tmp_path):
    from PIL import Image

    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.eval.reconstruction import reconstruction_eval
    from controlar_tpu_torch.models import discriminators, lpips
    from controlar_tpu_torch.train import control_step, multiscale, vq_train
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import step as tstep

    vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, encoder_ch_mult=(1, 1),
                    decoder_ch_mult=(1, 1))
    widths = (4, 4, 4, 4, 4)
    if name == "init_lpips":
        return lambda **d: lpips.init_lpips(widths=widths, **d)
    if name == "init_patchgan":
        return lambda **d: discriminators.init_patchgan(ndf=4, **d)
    if name == "init_stylegan_disc":
        return lambda **d: discriminators.init_stylegan_disc(image_size=8, **d)
    if name == "lpips_from_state_dicts":
        sds = convert_ref.lpips_reference_state_dicts(lpips.init_lpips(widths=widths,
                                                                       device="cpu"))
        return lambda **d: convert_ref.lpips_from_state_dicts(*sds, **d)
    if name == "patchgan_from_state_dict":
        sd = convert_ref.patchgan_reference_state_dict(discriminators.init_patchgan(
            ndf=4, device="cpu"))
        return lambda **d: convert_ref.patchgan_from_state_dict(sd, **d)
    if name == "stylegan_disc_from_state_dict":
        sd = convert_ref.stylegan_disc_reference_state_dict(discriminators.init_stylegan_disc(
            image_size=8, device="cpu"))
        return lambda **d: convert_ref.stylegan_disc_from_state_dict(sd, **d)
    images = tmp_path / "images"
    images.mkdir(exist_ok=True)
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(images / "0.png")
    if name == "train_vq":  # 32 px: PatchGAN's pyramid and VGG16's pools fit
        def train(**d):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(vq_train, "vq_config", lambda name: vcfg)
                return vq_train.train_vq(str(images), image_size=32, batch_size=1,
                                         max_steps=1, eval_after=0, results_dir=str(tmp_path),
                                         log=lambda m: None, **d)["vq"]

        return train
    if name == "eval_vq":  # VQ-16 from seed 0: only the refusal is checked
        return lambda **d: vq_train.eval_vq(str(images), image_size=16, **d)
    if name == "reconstruction_eval":
        vq = tvq.init_vq(vcfg)
        return lambda **d: reconstruction_eval(vq, vcfg, [np.zeros((1, 16, 16, 3), np.uint8)],
                                               **d)
    cfg = GPTConfig(model_type="t2i", dim=32, n_layer=3, n_head=2, vocab_size=16,
                    cls_token_num=4, caption_dim=8, block_size=4)
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, pos_grid=2)
    model = control_step.ControlModel(tgpt.init_gpt(cfg), tvit.init_vit(acfg))
    model.requires_grad_(True)
    model.gpt.cls_embedding.uncond_embedding.requires_grad_(False)
    tx = topt.make_optimizer(lr=1e-3)
    batch = {"images": torch.zeros(1, 32, 16, 3), "caption_emb": torch.zeros(1, 4, 8),
             "emb_mask": torch.ones(1, 4, dtype=torch.bool)}

    vcfg16 = dataclasses.replace(vcfg, encoder_ch_mult=(1,) * 5)  # /16, the adapter's grid

    def run(**d):
        fn = multiscale.make_multiscale_train_step(cfg, acfg, vcfg16, tx, "canny",
                                                   frozen={"vq": tvq.init_vq(vcfg16)},
                                                   compute_dtype=torch.float32, **d)
        state, m = fn(model, tstep.init_train_state(model, tx), batch, 0)
        assert state.step == 1 and np.isfinite(m["loss"].item())
        return None

    return run


@pytest.mark.parametrize("name", SLICE9_ENTRY_POINTS)
def test_slice9_entry_points_raise_without_a_card_unless_cpu_is_asked(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    call = _slice9_call(name, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    if name == "eval_vq":  # its CPU run is tests/test_torch_vq_train.py's reconstruction
        return
    out = call(device="cpu")
    if isinstance(out, torch.nn.Module):
        assert all(p.device.type == "cpu" for p in out.parameters())
    elif isinstance(out, dict):
        assert out["count"] == 1


# the evaluation slice (slice 13): name -> call(tmp_path, **device_kw)
SLICE13_ENTRY_POINTS = ("Evaluator", "sample_c2i_fid", "init_inception", "init_taming",
                        "load_mmseg_segmenter")


def _slice13_call(name, tmp_path):
    from controlar_tpu_torch.eval import evaluator, inception, sampler
    from controlar_tpu_torch.eval.deeplabv3 import DeepLabV3
    from controlar_tpu_torch.convert_mmseg import load_mmseg_segmenter
    from controlar_tpu_torch.models import taming_vqgan

    if name == "Evaluator":
        model = inception.init_inception(device="cpu")
        return lambda **d: evaluator.Evaluator(model, **d).model
    if name == "sample_c2i_fid":
        cfg, model = _tiny()
        vcfg = VQConfig(codebook_size=16, z_channels=8, ch=8, decoder_ch_mult=(1, 1))
        acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, pos_grid=2)
        pipe = ControlARPipeline(gpt_cfg=cfg, gpt=model, vq_cfg=vcfg, vq=tvq.init_vq(vcfg),
                                 adapter_cfg=acfg, adapter=tvit.init_vit(acfg), device="cpu")
        return lambda **d: sampler.sample_c2i_fid(pipe, 3, batch_size=2, num_classes=4,
                                                  top_k=4, **d)
    if name == "init_inception":
        return lambda **d: inception.init_inception(**d)
    if name == "init_taming":
        cfg = taming_vqgan.TamingVQConfig(ch=8, ch_mult=(1, 2), resolution=8,
                                          attn_resolutions=(4,), z_channels=4, n_embed=8,
                                          embed_dim=4)
        return lambda **d: taming_vqgan.init_taming(cfg, **d)
    torch.manual_seed(0)
    sd = DeepLabV3(depth=50, num_classes=3, base_channels=8, head_channels=8).state_dict()
    torch.save({"state_dict": sd}, tmp_path / "seg.pth")
    return lambda **d: load_mmseg_segmenter(str(tmp_path / "seg.pth"), **d)


@pytest.mark.parametrize("name", SLICE13_ENTRY_POINTS)
def test_slice13_entry_points_raise_without_a_card_unless_cpu_is_asked(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    call = _slice13_call(name, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    out = call(device="cpu")
    if isinstance(out, torch.nn.Module):
        assert all(p.device.type == "cpu" and not p.requires_grad for p in out.parameters())
    elif isinstance(out, np.ndarray):
        assert out.shape == (3, 4, 4, 3) and out.dtype == np.uint8
    else:  # the segmenter
        labels = out(np.zeros((1, 16, 16, 3), np.uint8))
        assert labels.shape == (1, 16, 16) and labels.max() < 3
