"""The port's depth estimators against the JAX package's, fp32 on the CPU:
DPT (HF `DPTForDepthEstimation` key layout) and MiDaS DPT-Hybrid (the
`dpt_hybrid-midas-501f0c75.pt` key layout), each loaded by the port's
`convert_ref` from the state dict the JAX converter reads, and by
`convert.*_from_jax` from the JAX tree.

DPT's state dict comes from a tiny random HF model (transformers is needed
by this test only); MiDaS's from the JAX package's `init_midas_params` and
`export_midas_state_dict` on a tiny configuration (trunk layers (1, 1, 1),
a 3-layer ViT of width 64).

Tolerances, relative to the largest |depth| of the JAX output: 2e-5 (fp32
through ~10 convolution and attention layers summed in another order); the
0..255 condition maps 5e-3 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.convert.torch_dpt import convert_dpt_state_dict
from controlar_tpu.convert.torch_midas import (
    convert_midas_state_dict,
    export_midas_state_dict,
)
from controlar_tpu.models import dpt as jdpt
from controlar_tpu.models import midas as jmidas
from controlar_tpu_torch import convert, convert_ref
from controlar_tpu_torch.models import dpt as tdpt
from controlar_tpu_torch.models import midas as tmidas

DEPTH_RTOL = 2e-5
MAP_ATOL = 5e-3

_DPT = dict(hidden_size=32, n_layer=4, n_head=2, mlp_dim=64, patch_size=16, pos_grid=4,
            out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 24, 32, 32),
            reassemble_factors=(4, 2, 1, 0.5), fusion_hidden_size=24)
_MIDAS = dict(stem_width=32, layers=(1, 1, 1), hidden_size=64, n_layer=3, n_head=2,
              mlp_dim=128, pos_grid=4, vit_hooks=(1, 2), features=32,
              layer_channels=(256, 512, 64, 64))


_jdpt_depth = jax.jit(jdpt.dpt_depth, static_argnums=1)
_jmidas_depth = jax.jit(jmidas.midas_hybrid_depth, static_argnums=1)
_WANT = {}  # (model, hw) -> the JAX package's depth: each shape is computed once


def _close(got, want, rtol=DEPTH_RTOL):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=rtol)


@pytest.fixture(scope="module")
def dpt_setup():
    pytest.importorskip("transformers")
    from transformers import DPTConfig as HFDPTConfig
    from transformers import DPTForDepthEstimation

    hf_cfg = HFDPTConfig(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                         intermediate_size=64, image_size=64, patch_size=16,
                         backbone_out_indices=(0, 1, 2, 3), neck_hidden_sizes=[16, 24, 32, 32],
                         reassemble_factors=[4, 2, 1, 0.5], fusion_hidden_size=24,
                         readout_type="project", is_hybrid=False)
    torch.manual_seed(0)
    model = DPTForDepthEstimation(hf_cfg).float().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # give the zero-initialised tokens and biases signal
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg = jdpt.DPTConfig(**_DPT)
    return sd, cfg, jax.tree.map(jnp.asarray, convert_dpt_state_dict(sd, cfg)), tdpt.DPTConfig(**_DPT)


@pytest.mark.parametrize("hw", [(64, 64), (96, 96)])  # native 4x4 grid; resized 6x6
@pytest.mark.parametrize("route", ["state_dict", "from_jax"])
def test_dpt_depth_matches_jax(dpt_setup, hw, route):
    sd, cfg, params, tcfg = dpt_setup
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    if ("dpt", hw) not in _WANT:
        _WANT["dpt", hw] = np.asarray(_jdpt_depth(params, cfg, jnp.asarray(x)))
    want = _WANT["dpt", hw]
    model = (convert_ref.dpt_from_state_dict(sd, tcfg, device="cpu") if route == "state_dict"
             else convert.dpt_from_jax(jax.tree.map(np.asarray, params), tcfg))
    _close(tdpt.dpt_depth(model, tcfg, torch.from_numpy(x)).numpy(), want)


def test_dpt_preprocess_and_condition_match_jax(dpt_setup):
    sd, cfg, params, tcfg = dpt_setup
    img = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    pre_j = jdpt.preprocess_depth_input(jnp.asarray(img), size=96)
    pre_t = tdpt.preprocess_depth_input(torch.from_numpy(img), size=96)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), atol=1e-5)
    want = np.asarray(jdpt.depth_to_condition(_jdpt_depth(params, cfg, pre_j)))
    model = convert_ref.dpt_from_state_dict(sd, tcfg, device="cpu")
    got = tdpt.depth_to_condition(tdpt.dpt_depth(model, tcfg, pre_t)).numpy()
    assert want.max() == pytest.approx(255.0)
    np.testing.assert_allclose(got, want, atol=MAP_ATOL)


def test_dpt_large_shapes_match_the_hf_layout():
    """DPT_LARGE's modules hold the parameters a DPT-Large state dict has,
    key for key through the loader's renaming (on the meta device)."""
    with torch.device("meta"):
        model = tdpt.DPT(tdpt.DPT_LARGE)
    n = sum(p.numel() for p in model.parameters())
    assert 340e6 < n < 345e6  # DPT-Large's depth model: ~343M
    assert model.reassemble[0].resize.weight.shape == (256, 256, 4, 4)  # transposed
    assert model.reassemble[3].resize.weight.shape == (1024, 1024, 3, 3)
    assert not hasattr(model.reassemble[2], "resize")


@pytest.fixture(scope="module")
def midas_setup():
    cfg = jmidas.MidasHybridConfig(**_MIDAS)
    params = jax.jit(jmidas.init_midas_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)  # non-trivial norms and biases
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32)), params)
    sd = export_midas_state_dict(params, cfg)
    return cfg, params, sd, tmidas.MidasHybridConfig(**_MIDAS)


def test_midas_export_roundtrips_through_the_jax_converter(midas_setup):
    cfg, params, sd, _ = midas_setup
    back = convert_midas_state_dict(sd, cfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (96, 96)])
@pytest.mark.parametrize("route", ["state_dict", "from_jax"])
def test_midas_depth_matches_jax(midas_setup, hw, route):
    cfg, params, sd, tcfg = midas_setup
    x = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    if ("midas", hw) not in _WANT:
        _WANT["midas", hw] = np.asarray(_jmidas_depth(params, cfg, jnp.asarray(x)))
    want = _WANT["midas", hw]
    model = (convert_ref.midas_from_state_dict(sd, tcfg, device="cpu") if route == "state_dict"
             else convert.midas_from_jax(jax.tree.map(np.asarray, params), tcfg))
    _close(tmidas.midas_hybrid_depth(model, tcfg, torch.from_numpy(x)).numpy(), want)


def test_midas_depth_condition_matches_jax(midas_setup):
    cfg, params, sd, tcfg = midas_setup
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(jmidas.midas_depth_condition, static_argnums=1)(
        params, cfg, jnp.asarray(img)))
    model = convert_ref.midas_from_state_dict(sd, tcfg, device="cpu")
    got = tmidas.midas_depth_condition(model, tcfg, torch.from_numpy(img)).numpy()
    assert want.min() == 0.0 and want.max() == pytest.approx(255.0)
    np.testing.assert_allclose(got, want, atol=MAP_ATOL)


def test_midas_checkpoint_file_loads(midas_setup, tmp_path):
    """load_midas_checkpoint reads a .pt state dict, bare or under "model"."""
    _, _, sd, tcfg = midas_setup
    tsd = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    want = convert_ref.midas_from_state_dict(sd, tcfg, device="cpu").state_dict()
    for i, payload in enumerate((tsd, {"model": tsd})):
        torch.save(payload, tmp_path / f"m{i}.pt")
        got = convert_ref.load_midas_checkpoint(str(tmp_path / f"m{i}.pt"), tcfg,
                                                device="cpu").state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_midas_random_builder_follows_the_jax_init():
    """init_midas at the released width: the JAX init's distribution
    (weights std 0.05, zero biases, unit norms, tables std 0.02) and the
    parameter count of timm's vit_base_resnet50_384 DPT (~123M)."""
    cfg = tmidas.MidasHybridConfig(**_MIDAS)
    model = tmidas.init_midas(cfg, seed=0, device="cpu")
    sd = model.state_dict()
    assert sd["blocks.0.qkv.weight"].std().item() == pytest.approx(0.05, rel=0.05)
    assert sd["pos_embed"].std().item() == pytest.approx(0.02, rel=0.05)
    assert torch.all(sd["backbone.stem.norm.scale"] == 1) and torch.all(sd["head.conv1.bias"] == 0)
    with torch.device("meta"):
        full = tmidas.MidasHybrid(tmidas.MIDAS_HYBRID)
    assert 120e6 < sum(p.numel() for p in full.parameters()) < 126e6
    jp = jax.eval_shape(lambda k: jmidas.init_midas_params(k, jmidas.MidasHybridConfig(**_MIDAS)),
                        jax.random.PRNGKey(0))
    assert sum(a.size for a in jax.tree.leaves(jp)) == sum(p.numel() for p in model.parameters())
