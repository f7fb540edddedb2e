"""The port's checkpoint loaders against the JAX package's, on the CPU at
tiny widths: the reference layouts (.pt with each wrapper, .safetensors),
the JAX package's .npz dumps both ways, the port's step directories, the
base-checkpoint fallback, and `TrainerConfig.gpt_ckpt`.

A loaded module is held to the JAX converter's tree two ways: its
parameters equal `convert.*_from_jax` of that tree bit for bit (fp32, or the
file's bf16), and its forward equals the JAX forward on that tree within
1e-4 absolute (fp32 on both sides, sums in another order).
"""
import argparse
import json
import os
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import checkpoint as jckpt
from controlar_tpu import tools as jtools
from controlar_tpu.config import GPTConfig, VQConfig
from controlar_tpu.convert.torch_gpt import convert_gpt_state_dict
from controlar_tpu.convert.torch_vit import convert_hf_vit_state_dict
from controlar_tpu.convert.torch_vq import convert_vq_state_dict
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu_torch import checkpoint as ckpt
from controlar_tpu_torch import convert
from controlar_tpu_torch import convert_ref
from controlar_tpu_torch import tools as ttools
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq
from tests.test_torch_vq_encoder import _random_params as _random_vq_params

ATOL = 1e-4
_GPT = dict(dim=64, n_layer=3, n_head=4, vocab_size=96, num_classes=10, caption_dim=24,
            adapter_size="small", block_size=16)
_VQ = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16,
           encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2))
# keys of a ControlAR checkpoint that the GPT loaders do not read
_SKIPPED = {"adapter.model.embeddings.cls_token": np.zeros((1, 1, 8), np.float32),
            "condition_embeddings.weight": np.zeros((4, 8), np.float32),
            "condition_norm.weight": np.ones(8, np.float32)}


def _gpt_kw(model_type):
    return dict(_GPT, model_type=model_type, cls_token_num=1 if model_type == "c2i" else 6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gpt_params(model_type, seed=0):
    """JAX params with every leaf non-trivial (the t2i head is zero at init)."""
    cfg = GPTConfig(**_gpt_kw(model_type))
    params = jgpt.init_gpt_params(jax.random.PRNGKey(seed), cfg)
    params["output"] = jax.random.normal(jax.random.PRNGKey(seed + 1), params["output"].shape)
    return cfg, TGPTConfig(**_gpt_kw(model_type)), _np(params)


def _ref_sd(model):
    """A reference-layout state dict of a port GPT, with the keys the
    loaders skip."""
    sd = {k: v.clone() for k, v in convert_ref.gpt_reference_state_dict(model).items()}
    sd.update({k: torch.from_numpy(v) for k, v in _SKIPPED.items()})
    return sd


def _same_module(got, want):
    sg, sw = got.state_dict(), want.state_dict()
    assert set(sg) == set(sw)
    for k in sw:
        assert sg[k].dtype == sw[k].dtype and torch.equal(sg[k], sw[k]), k


def _gpt_forward_close(model, tcfg, jparams, jcfg, seed=0):
    """Teacher-forced logits with control tokens, port against JAX (einsum
    attention, deterministic, fp32)."""
    rng = np.random.default_rng(seed)
    b = 2
    if jcfg.model_type == "c2i":
        labels = np.array([1, 7])
        jprefix = jgpt.embed_prefix_c2i(jparams, jnp.asarray(labels))
        tprefix = tgpt.embed_prefix_c2i(model, torch.from_numpy(labels))
    else:
        cap = rng.standard_normal((b, jcfg.cls_token_num, jcfg.caption_dim)).astype(np.float32)
        jprefix = jgpt.embed_prefix_t2i(jparams, jnp.asarray(cap))
        tprefix = tgpt.embed_prefix_t2i(model, torch.from_numpy(cap))
    feats = rng.standard_normal((b, jcfg.block_size, jcfg.adapter_dim)).astype(np.float32)
    idx = rng.integers(0, jcfg.vocab_size, (b, jcfg.block_size - 1)).astype(np.int32)

    @jax.jit
    def jfwd(p):
        cond = jgpt.control_tokens(p, jcfg, jnp.asarray(feats))
        return jgpt.forward_train(p, jcfg, jprefix, jnp.asarray(idx), cond_tokens=cond,
                                  attn_impl="einsum")[0]

    with torch.no_grad():
        cond = tgpt.control_tokens(model, tcfg, torch.from_numpy(feats))
        got = tgpt.forward_train(model, tcfg, tprefix, torch.from_numpy(idx).long(),
                                 cond_tokens=cond, attn_impl="einsum")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jfwd(jax.tree.map(jnp.asarray,
                                                                           jparams))), atol=ATOL)


@pytest.mark.parametrize("model_type", ["c2i", "t2i"])
def test_gpt_reference_layout_is_the_jax_converters(model_type):
    """The port's table, read from the module's side, writes the layout that
    `convert_gpt_state_dict` reads back to the same tree; the port's loader
    of that layout computes what the JAX forward computes on it."""
    jcfg, tcfg, params = _gpt_params(model_type)
    sd = _ref_sd(convert.gpt_from_jax(params, tcfg))
    back = convert_gpt_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    model = convert_ref.gpt_from_state_dict(sd, tcfg, device="cpu")
    _same_module(model, convert.gpt_from_jax(back, tcfg))
    _gpt_forward_close(model, tcfg, back, jcfg)


@pytest.mark.parametrize("wrapper", ["model", "module", "state_dict", None])
def test_gpt_pt_wrappers(tmp_path, wrapper):
    jcfg, tcfg, params = _gpt_params("c2i", seed=2)
    sd = _ref_sd(convert.gpt_from_jax(params, tcfg))
    path = str(tmp_path / "gpt.pt")
    torch.save(sd if wrapper is None else {wrapper: sd, "steps": 10}, path)
    got = ckpt.load_gpt_checkpoint(path, tcfg, device="cpu")
    _same_module(got, convert.gpt_from_jax(_np(jckpt.load_gpt_checkpoint(path, jcfg)), tcfg))


class _NotAWeight:
    pass


def test_pt_args_namespace_and_untrusted_objects(tmp_path):
    """The reference saves argparse.Namespace as "args" beside the model:
    that loads under weights_only; any other object is refused."""
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "args.pt")
    torch.save({"model": sd, "args": argparse.Namespace(gpt_model="GPT-B", lr=1e-4)}, path)
    assert torch.equal(ckpt.load_torch_file(path)["w"], sd["w"])
    path = str(tmp_path / "object.pt")
    torch.save({"model": sd, "extra": _NotAWeight()}, path)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        ckpt.load_torch_file(path)


_ST_TENSORS = {
    "f32": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
    "f16": torch.randn(4, generator=torch.Generator().manual_seed(1)).half(),
    "bf16": torch.randn(2, 3, 2, generator=torch.Generator().manual_seed(2)).bfloat16(),
    "i64": torch.arange(-3, 5),
    "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
    "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
    "u8": torch.tensor([0, 255], dtype=torch.uint8),
    "flag": torch.tensor([True, False, True]),
    "scalar": torch.tensor(2.5),
    "empty": torch.zeros(0, 4),
}


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_written_by_the_library_read_by_the_port(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "lib.safetensors")
    save_file(_ST_TENSORS, path, metadata={"format": "pt"})
    _equal_dicts(ckpt.load_safetensors(path), _ST_TENSORS)


def test_safetensors_written_by_the_port_read_by_the_library(tmp_path):
    from safetensors.torch import load_file

    path = str(tmp_path / "port.safetensors")
    ckpt.save_safetensors(_ST_TENSORS, path)
    _equal_dicts(load_file(path), _ST_TENSORS)
    _equal_dicts(ckpt.load_safetensors(path), _ST_TENSORS)


def test_safetensors_bf16_written_by_hand(tmp_path):
    """A file laid out by hand: the little-endian header length, the JSON
    header, then bf16 bits 0x3FC0 (1.5), 0xC000 (-2.0), 0x0000, 0x7F80 (inf)."""
    header = json.dumps({"x": {"dtype": "BF16", "shape": [2, 2], "data_offsets": [0, 8]}})
    raw = struct.pack("<4H", 0x3FC0, 0xC000, 0x0000, 0x7F80)
    path = str(tmp_path / "hand.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header.encode() + raw)
    x = ckpt.load_safetensors(path)["x"]
    assert x.dtype == torch.bfloat16
    assert x.float().tolist() == [[1.5, -2.0], [0.0, float("inf")]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt_safetensors_in_its_dtype(tmp_path, dtype):
    jcfg, tcfg, params = _gpt_params("t2i", seed=3)
    src = convert.gpt_from_jax(params, tcfg)
    sd = {k: v.to(dtype) for k, v in _ref_sd(src).items()}
    path = str(tmp_path / "gpt.safetensors")
    ckpt.save_safetensors(sd, path)
    got = ckpt.load_gpt_checkpoint(path, tcfg, dtype=dtype, device="cpu")
    _same_module(got, src.to(dtype))
    # the JAX package's loader reads the same file (through its safetensors
    # package) to the same tree
    if dtype == torch.float32:
        _same_module(got, convert.gpt_from_jax(_np(jckpt.load_gpt_checkpoint(path, jcfg)), tcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_jax_to_port(tmp_path, dtype):
    jcfg, tcfg, params = _gpt_params("c2i", seed=4)
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    path = str(tmp_path / "jax.npz")
    jtools.export_params_npz(tree, path)
    back = ttools.import_params_npz(path)
    want_dtype = getattr(torch, dtype)
    assert back["layers"]["wqkv"].dtype == want_dtype
    np.testing.assert_array_equal(back["layers"]["wqkv"].float().numpy(),
                                  np.asarray(tree["layers"]["wqkv"], np.float32))
    got = ckpt.load_gpt_checkpoint(path, tcfg, dtype=want_dtype, device="cpu")
    _same_module(got, convert.gpt_from_jax(params, tcfg).to(want_dtype)
                 if dtype == "float32" else
                 convert.gpt_from_jax(_np(jax.tree.map(lambda a: a.astype(jnp.float32), tree)),
                                      tcfg).to(want_dtype))


def test_npz_port_to_jax(tmp_path):
    tree = {"w": torch.randn(3, 4).bfloat16(), "b": [torch.arange(4.0), torch.ones(2)],
            "n": {"i": torch.arange(3, dtype=torch.int32)}}
    path = str(tmp_path / "port.npz")
    ttools.export_params_npz(tree, path)
    back = jtools.import_params_npz(path)
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32), tree["w"].float().numpy())
    np.testing.assert_array_equal(back["b"]["1"], np.ones(2, np.float32))
    np.testing.assert_array_equal(back["n"]["i"], np.arange(3, dtype=np.int32))
    mine = ttools.import_params_npz(path)
    assert torch.equal(mine["w"], tree["w"]) and torch.equal(mine["b"]["0"], tree["b"][0])


@pytest.mark.parametrize("fill_seed", [None, 11])
def test_base_checkpoint_fallback(tmp_path, fill_seed):
    """A base LlamaGen checkpoint has no adapter_mlp, condition_mlp or
    condition_layers: those come from the GPT given as fill_from, else from
    the port's init_gpt(cfg, 0) (the JAX converter draws them from its own
    PRNG), the rest from the file as the JAX converter reads it."""
    jcfg, tcfg, params = _gpt_params("c2i", seed=5)
    sd = {k: v for k, v in _ref_sd(convert.gpt_from_jax(params, tcfg)).items()
          if not k.startswith(convert_ref.CONTROL_MODULES)}
    path = str(tmp_path / "base.pt")
    torch.save({"model": sd}, path)
    fill = None if fill_seed is None else tgpt.init_gpt(tcfg, seed=fill_seed)
    got = ckpt.load_gpt_checkpoint(path, tcfg, device="cpu", fill_from=fill).state_dict()
    fresh = tgpt.init_gpt(tcfg, seed=fill_seed or 0).state_dict()
    jax_tree = convert.gpt_from_jax(_np(jckpt.load_gpt_checkpoint(path, jcfg)),
                                    tcfg).state_dict()
    for k, v in got.items():
        want = fresh[k] if k.startswith(convert_ref.CONTROL_MODULES) else jax_tree[k]
        assert torch.equal(v, want), k
    del sd["norm.weight"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="norm.weight"):
        ckpt.load_gpt_checkpoint(path, tcfg, device="cpu")


def test_port_step_directories(tmp_path):
    """A results directory of the port's trainer (parameters under "gpt."
    and "adapter."), the latest step wins and its EMA is taken first; a bare
    GPT's step."""
    from controlar_tpu_torch.train.optimizer import AdamState
    from controlar_tpu_torch.train.step import TrainState

    _, tcfg, _ = _gpt_params("c2i")
    acfg = tvit.ViTConfig(hidden_size=32, n_layer=1, n_head=2, pos_grid=2)
    models = {step: tgpt.init_gpt(tcfg, seed=step) for step in (2, 5)}
    adapter = tvit.init_vit(acfg, seed=1)
    ckpt_dir = str(tmp_path / "results" / "checkpoints")
    for step, m in models.items():
        params = {f"gpt.{k}": v for k, v in m.state_dict().items()}
        params.update({f"adapter.{k}": v for k, v in adapter.state_dict().items()})
        ema = {k: v + 1 for k, v in params.items()} if step == 5 else None
        ckpt.save_train_state(ckpt_dir, TrainState(step, params, AdamState(0, {}, {}), ema))
    got = ckpt.load_gpt_checkpoint(str(tmp_path / "results"), tcfg, device="cpu")
    for k, v in got.state_dict().items():
        assert torch.equal(v, models[5].state_dict()[k] + 1), k
    got = ckpt.load_adapter_checkpoint(str(tmp_path / "results"), acfg, device="cpu")
    for k, v in got.state_dict().items():
        assert torch.equal(v, adapter.state_dict()[k] + 1), k
    got = ckpt.load_gpt_checkpoint(os.path.join(ckpt_dir, "step_00000002"), tcfg,
                                   dtype=torch.bfloat16, device="cpu")
    _same_module(got, models[2].to(torch.bfloat16))
    bare = str(tmp_path / "bare")
    ckpt.save_train_state(bare, TrainState(3, dict(models[5].state_dict()),
                                           AdamState(0, {}, {})))
    _same_module(ckpt.load_gpt_checkpoint(bare, tcfg, dtype=torch.bfloat16, device="cpu"),
                 models[5].to(torch.bfloat16))


def test_orbax_directory_names_its_format(tmp_path):
    step = tmp_path / "run" / "step_00000007"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    _, tcfg, _ = _gpt_params("c2i")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_gpt_checkpoint(str(tmp_path / "run"), tcfg, device="cpu")


def _vq_pair(seed=0):
    cfg = VQConfig(**_VQ)
    return cfg, TVQConfig(**_VQ), _random_vq_params(cfg, seed)


@pytest.mark.parametrize("fmt", ["pt", "safetensors", "npz"])
def test_vq_loader(tmp_path, fmt):
    jcfg, tcfg, params = _vq_pair()
    src = convert.vq_from_jax(params, tcfg)
    sd = convert_ref.vq_reference_state_dict(src)
    # the reference layout reads back to the same tree through the JAX converter
    back = convert_vq_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / f"vq.{fmt}")
    if fmt == "pt":
        torch.save({"model": sd}, path)
    elif fmt == "safetensors":
        ckpt.save_safetensors(sd, path)
    else:
        jtools.export_params_npz({"ema_params": params}, path)
    got = ckpt.load_vq_checkpoint(path, tcfg, device="cpu")
    _same_module(got, src)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jzq, jidx = jax.jit(lambda p, xx: jvq.encode(p, jcfg, xx))(params, jnp.asarray(x))
    _, tidx = tvq.encode(got, tcfg, torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    want = jax.jit(lambda p, i: jvq.decode_code(p, jcfg, i))(params, jidx)
    np.testing.assert_allclose(tvq.decode_code(got, tcfg, tidx).numpy(), np.asarray(want),
                               atol=ATOL)


def test_adapter_from_jax_npz(tmp_path):
    """A JAX .npz dump of the adapter, alone or as a control state's
    "adapter"."""
    cfg = jvit.ViTConfig(hidden_size=32, n_layer=2, n_head=2, patch_size=14, pos_grid=4)
    tcfg = tvit.ViTConfig(hidden_size=32, n_layer=2, n_head=2, patch_size=14, pos_grid=4)
    params = _np(jvit.init_vit_params(jax.random.PRNGKey(3), cfg))
    want = convert.vit_from_jax(params, tcfg)
    for tree in (params, {"params": {"gpt": {"norm": np.ones(4, np.float32)},
                                     "adapter": params}}):
        path = str(tmp_path / "adapter.npz")
        jtools.export_params_npz(tree, path)
        _same_module(ckpt.load_adapter_checkpoint(path, tcfg, device="cpu"), want)


def _hf_model(flavor):
    if flavor == "dinov2":
        from transformers import Dinov2Config, Dinov2Model

        torch.manual_seed(0)
        model = Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                         num_attention_heads=2, mlp_ratio=4, image_size=56,
                                         patch_size=14, layerscale_value=0.7))
        cfg = dict(layerscale=True, layer_norm_eps=1e-6)
    else:
        from transformers import ViTConfig, ViTModel

        torch.manual_seed(0)
        model = ViTModel(ViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                   intermediate_size=128, image_size=56, patch_size=14),
                         add_pooling_layer=False)
        cfg = dict(layerscale=False, layer_norm_eps=1e-12)
    with torch.no_grad():  # non-trivial norms and biases
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    kw = dict(hidden_size=32, n_layer=2, n_head=2, patch_size=14, pos_grid=4, **cfg)
    return model.eval(), jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)


@pytest.mark.parametrize("flavor", ["dinov2", "vit"])
@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_adapter_loader(tmp_path, flavor, fmt):
    """An HF state dict file -> the port's ViT, against the JAX converter's
    tree through the JAX forward; the reverse table writes the HF keys back."""
    hf, jcfg, tcfg = _hf_model(flavor)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    path = str(tmp_path / f"adapter.{fmt}")
    (torch.save if fmt == "pt" else ckpt.save_safetensors)(sd, path)
    got = ckpt.load_adapter_checkpoint(path, tcfg, flavor, device="cpu")
    jparams = convert_hf_vit_state_dict(sd, jcfg, flavor)
    _same_module(got, convert.vit_from_jax(jparams, tcfg))
    x = np.random.default_rng(2).standard_normal((2, 56, 70, 3)).astype(np.float32)
    want = jax.jit(lambda p, xx: jvit.vit_forward(p, jcfg, xx))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    np.testing.assert_allclose(tvit.vit_forward(got, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=ATOL)
    written = convert_ref.vit_hf_state_dict(got, tcfg, flavor)
    assert set(written) <= set(sd)
    for k, v in written.items():
        assert torch.equal(v, sd[k]), k


# a trainer at tiny widths (TrainerConfig keywords)
_TRAINER_KW = dict(gpt_model="GPT-B", image_size=64, cls_token_num=8, global_batch_size=2,
                   log_every=1, ckpt_every=100, dropout_p=0.0, class_dropout_prob=0.0,
                   model_overrides=dict(dim=64, n_layer=3, n_head=4, vocab_size=64,
                                        caption_dim=32),
                   adapter_override=tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2,
                                                   pos_grid=4))


def test_trainer_keeps_its_control_modules_on_a_base_checkpoint(tmp_path):
    """TrainerConfig.gpt_ckpt of a base checkpoint: the trainer's GPT takes
    the file's parameters and keeps its own fresh control modules (those of
    a trainer without the checkpoint)."""
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    fresh = Trainer(TrainerConfig(results_dir=str(tmp_path / "a"), seed=3, **_TRAINER_KW),
                    device="cpu")
    fresh.init_state()
    weights = tgpt.init_gpt(fresh.gpt_cfg, seed=9)
    path = str(tmp_path / "base.safetensors")
    ckpt.save_safetensors({k: v for k, v in convert_ref.gpt_reference_state_dict(weights).items()
                           if not k.startswith(convert_ref.CONTROL_MODULES)}, path)
    loaded = Trainer(TrainerConfig(results_dir=str(tmp_path / "b"), seed=3, gpt_ckpt=path,
                                   **_TRAINER_KW), device="cpu")
    loaded.init_state()
    for n, p in loaded.model.gpt.named_parameters():
        want = fresh.model.gpt if n.startswith(convert_ref.CONTROL_MODULES) else weights
        assert torch.equal(p, want.state_dict()[n]), n


def test_trainer_trains_from_gpt_ckpt(tmp_path):
    """TrainerConfig.gpt_ckpt: the loaded GPT's weights go into the trainer's
    fp32 parameters, so its first loss is that of a trainer whose GPT was
    given the same weights by hand."""
    from controlar_tpu_torch.cells import FixedBatchLoader
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    kw = _TRAINER_KW
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (2, 16)).astype(np.int32),
             "control_image": rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
             "caption_emb": rng.standard_normal((2, 8, 32)).astype(np.float32),
             "emb_mask": np.ones((2, 8), np.int32), "valid": np.ones((2,), np.float32)}
    gcfg = Trainer(TrainerConfig(results_dir=str(tmp_path / "probe"), **kw),
                   device="cpu").gpt_cfg
    weights = tgpt.init_gpt(gcfg, seed=9)
    path = str(tmp_path / "gpt.safetensors")
    ckpt.save_safetensors(convert_ref.gpt_reference_state_dict(weights), path)

    loaded = Trainer(TrainerConfig(results_dir=str(tmp_path / "a"), gpt_ckpt=path, **kw),
                     device="cpu")
    by_hand = Trainer(TrainerConfig(results_dir=str(tmp_path / "b"), **kw), device="cpu")
    state_b = by_hand.init_state()
    with torch.no_grad():
        for n, p in by_hand.model.gpt.named_parameters():
            p.copy_(weights.state_dict()[n])
    state_a = loaded.init_state()
    for n, p in loaded.model.gpt.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, weights.state_dict()[n]), n
    loaded.fit(FixedBatchLoader(batch, 1), state_a, max_steps=1)
    by_hand.fit(FixedBatchLoader(batch, 1), state_b, max_steps=1)
    assert loaded.history[0]["loss"] == by_hand.history[0]["loss"]
