"""The port's convolution helpers, instance norm, HED, lineart and hed_nms
against the JAX package's, fp32 on the CPU.

The networks get one random state dict in the published checkpoints' key
layouts (ControlNetHED.pth, the lineart sk_model.pth), loaded by the JAX
package's converter and by the port's `convert_ref`; the JAX trees also go
through `convert.*_from_jax`.

Tolerances: the ops 1e-5 absolute (fp32, a few products summed in another
order); lineart's sigmoid output 1e-5; HED's 0..255 output 2e-3 (255 x the
sigmoid's slope, at most 64, times fp32 sums of 13 convolutions in another
order); hed_nms bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.convert.torch_control import (
    _conv_transpose,
    convert_hed_state_dict,
    convert_lineart_state_dict,
)
from controlar_tpu.models import control_nets as jcn
from controlar_tpu.ops import conv as jconv
from controlar_tpu.ops import norms as jnorms
from controlar_tpu_torch import convert, convert_ref
from controlar_tpu_torch.models import control_nets as tcn
from controlar_tpu_torch.ops import conv as tconv
from controlar_tpu_torch.ops import norms as tnorms

OP_ATOL = 1e-5
HED_ATOL = 2e-3
LINEART_ATOL = 1e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _hwio(w):
    """torch OIHW -> HWIO."""
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,k,stride,padding", [
    ((17, 16), 3, 1, "SAME"),
    ((16, 16), 3, 2, "SAME"),          # XLA SAME at stride 2: (0, 1)
    ((15, 17), 7, 2, "SAME"),          # odd sizes: (3, 3) / (2, 3)
    ((16, 16), 1, 2, "SAME"),          # a 1x1 at stride 2 pads nothing
    ((16, 16), 4, 1, "SAME"),          # an even kernel: (1, 2)
    ((16, 12), 3, 2, ((1, 1), (1, 1))),
    ((16, 12), 3, 1, ((0, 2), (1, 0))),
    ((16, 16), 5, 1, "VALID"),
])
def test_conv2d(hw, k, stride, padding):
    x, w, b = _x((2, *hw, 3)), _x((5, 3, k, k), 1), _x((5,), 2)
    want = jconv.conv2d(jnp.asarray(x), _hwio(w), jnp.asarray(b), stride=stride,
                        padding=padding)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       stride=stride, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)


@pytest.mark.parametrize("k,stride,padding,output_padding", [(3, 2, 1, 1), (4, 4, 0, 0),
                                                             (2, 2, 0, 0)])
def test_conv_transpose2d(k, stride, padding, output_padding):
    """torch's (C_in, C_out, KH, KW) weight against the JAX package's
    flipped HWIO form, made by its converter."""
    x, w, b = _x((2, 5, 6, 4)), _x((4, 3, k, k), 1), _x((3,), 2)
    jp = _conv_transpose({"t.weight": w, "t.bias": b}, "t")
    want = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(jp["w"]), jnp.asarray(jp["b"]),
                                  stride=stride, padding=padding,
                                  output_padding=output_padding)
    got = tconv.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 stride=stride, padding=padding, output_padding=output_padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)


@pytest.mark.parametrize("hw", [(16, 16), (15, 17)])
def test_max_pools(hw):
    x = _x((2, *hw, 3))
    np.testing.assert_array_equal(tconv.max_pool2d(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconv.max_pool2d(jnp.asarray(x))))
    # the -inf SAME pool of the MiDaS trunk; all-negative input shows a 0 pad
    neg = -np.abs(x) - 1.0
    want = jax.lax.reduce_window(jnp.asarray(neg), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = tconv.max_pool2d_same(torch.from_numpy(neg), 3, 2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reflect_pad_and_instance_norm():
    x = _x((2, 9, 7, 3), scale=3.0) + 1.0
    np.testing.assert_array_equal(tconv.reflect_pad2d(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jconv.reflect_pad2d(jnp.asarray(x), 3)))
    np.testing.assert_allclose(tnorms.instance_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jnorms.instance_norm(jnp.asarray(x))), atol=OP_ATOL)


# ---------------------------------------------------------------------------
# HED and lineart, from the reference key layouts
# ---------------------------------------------------------------------------

def _conv_sd(sd, prefix, c_in, c_out, k, rng, transposed=False):
    shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
    sd[f"{prefix}.weight"] = (rng.standard_normal(shape) * (c_in * k * k) ** -0.5
                              ).astype(np.float32)
    sd[f"{prefix}.bias"] = (rng.standard_normal(c_out) * 0.1).astype(np.float32)


def hed_state_dict(seed=0, channels=tcn.HED_CHANNELS):
    """ControlNetHED_Apache2's keys: norm (1, 3, 1, 1), block{1..5}.convs.j,
    block{i}.projection."""
    rng = np.random.default_rng(seed)
    sd = {"norm": rng.uniform(90, 130, (1, 3, 1, 1)).astype(np.float32)}
    c_in = 3
    for i, (c, n) in enumerate(zip(channels, tcn.HED_CONVS), start=1):
        for j in range(n):
            _conv_sd(sd, f"block{i}.convs.{j}", c_in if j == 0 else c, c, 3, rng)
        _conv_sd(sd, f"block{i}.projection", c, 1, 1, rng)
        c_in = c
    return sd


def lineart_state_dict(seed=0, ngf=tcn.LINEART_NGF):
    """The pix2pix generator's Sequential keys (model0.1, model1.0/3,
    model2.i.conv_block.1/5, model3.0/3 transposed, model4.1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    _conv_sd(sd, "model0.1", 3, ngf, 7, rng)
    _conv_sd(sd, "model1.0", ngf, 2 * ngf, 3, rng)
    _conv_sd(sd, "model1.3", 2 * ngf, 4 * ngf, 3, rng)
    for i in range(3):
        _conv_sd(sd, f"model2.{i}.conv_block.1", 4 * ngf, 4 * ngf, 3, rng)
        _conv_sd(sd, f"model2.{i}.conv_block.5", 4 * ngf, 4 * ngf, 3, rng)
    _conv_sd(sd, "model3.0", 4 * ngf, 2 * ngf, 3, rng, transposed=True)
    _conv_sd(sd, "model3.3", 2 * ngf, ngf, 3, rng, transposed=True)
    _conv_sd(sd, "model4.1", ngf, 1, 7, rng)
    return sd


def _rgb(b, h, w, seed=3):
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def hed_pair():
    sd = hed_state_dict()
    return jax.tree.map(jnp.asarray, convert_hed_state_dict(sd)), sd


@pytest.fixture(scope="module")
def lineart_pair():
    sd = lineart_state_dict()
    return jax.tree.map(jnp.asarray, convert_lineart_state_dict(sd)), sd


@pytest.mark.parametrize("hw", [(64, 64), (48, 40)])
@pytest.mark.parametrize("route", ["state_dict", "from_jax"])
def test_hed_matches_jax(hed_pair, hw, route):
    params, sd = hed_pair
    x = _rgb(2, *hw)
    want = np.asarray(jcn.hed_forward(params, jnp.asarray(x)))
    net = (convert_ref.hed_from_state_dict(sd, device="cpu") if route == "state_dict"
           else convert.hed_from_jax(jax.tree.map(np.asarray, params)))
    got = tcn.hed_forward(net, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw)
    assert want.std() > 1.0  # a real edge map, not a saturated one
    np.testing.assert_allclose(got, want, atol=HED_ATOL)


@pytest.mark.parametrize("hw", [(64, 64), (32, 48)])
@pytest.mark.parametrize("route", ["state_dict", "from_jax"])
def test_lineart_matches_jax(lineart_pair, hw, route):
    params, sd = lineart_pair
    x = _rgb(2, *hw, seed=4)
    want = np.asarray(jcn.lineart_forward(params, jnp.asarray(x)))
    net = (convert_ref.lineart_from_state_dict(sd, device="cpu") if route == "state_dict"
           else convert.lineart_from_jax(jax.tree.map(np.asarray, params)))
    got = tcn.lineart_forward(net, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=LINEART_ATOL)


def test_narrow_widths_are_read_from_the_state_dict():
    hed = convert_ref.hed_from_state_dict(hed_state_dict(1, (4, 8, 8, 16, 16)), device="cpu")
    assert [b.projection.weight.shape[1] for b in hed.blocks] == [4, 8, 8, 16, 16]
    assert [len(b.convs) for b in hed.blocks] == list(tcn.HED_CONVS)
    la = convert_ref.lineart_from_state_dict(lineart_state_dict(1, ngf=8), device="cpu")
    assert la.model0.weight.shape == (8, 3, 7, 7)
    assert la.model3[0].weight.shape == (32, 16, 3, 3)  # transposed: (C_in, C_out, k, k)
    assert not any(p.requires_grad for p in (*hed.parameters(), *la.parameters()))


def test_loader_needs_every_key():
    sd = hed_state_dict(1, (4, 8, 8, 16, 16))
    del sd["block3.convs.2.bias"]
    with pytest.raises(KeyError, match="block3.convs.2.bias"):
        convert_ref.hed_from_state_dict(sd, device="cpu")


def test_random_builders_give_reference_shapes():
    """init_hed / init_lineart build the reference widths: the same shapes as
    the modules loaded from the reference layouts."""
    pairs = [(tcn.init_hed(seed=0, device="cpu"),
              convert_ref.hed_from_state_dict(hed_state_dict(), device="cpu")),
             (tcn.init_lineart(seed=0, device="cpu"),
              convert_ref.lineart_from_state_dict(lineart_state_dict(), device="cpu"))]
    x = torch.from_numpy(_rgb(1, 32, 32))
    for (made, loaded), fwd in zip(pairs, (tcn.hed_forward, tcn.lineart_forward)):
        assert ({k: v.shape for k, v in made.state_dict().items()}
                == {k: v.shape for k, v in loaded.state_dict().items()})
        assert torch.isfinite(fwd(made, x)).all()


# ---------------------------------------------------------------------------
# hed_nms
# ---------------------------------------------------------------------------

def _edge_maps():
    rng = np.random.default_rng(5)
    smooth = rng.uniform(0, 255, (2, 40, 56)).astype(np.float32)
    # blocky maps: plateaus and equal neighbours, so the >= ties decide
    blocks = rng.integers(0, 4, (2, 10, 14)).astype(np.float32) * 80.0
    blocks = blocks.repeat(4, axis=1).repeat(4, axis=2)
    ridges = np.zeros((2, 40, 56), np.float32)
    ridges[:, ::7, :] = 200.0
    ridges[:, :, ::9] = 120.0
    return {"smooth": smooth, "blocks": blocks, "ridges": ridges}


@pytest.mark.parametrize("kind", ["smooth", "blocks", "ridges"])
@pytest.mark.parametrize("s,t", [(2.0, 64.0), (3.0, 32.0), (1.0, 60.0)])
def test_hed_nms_bit_exact(kind, s, t):
    x = _edge_maps()[kind]
    want = np.asarray(jcn.hed_nms(jnp.asarray(x), t, s))
    got = tcn.hed_nms(torch.from_numpy(x), t, s).numpy()
    assert got.dtype == np.uint8 and got.shape == x.shape
    assert 0 < (want == 255).mean() < 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcn.hed_nms(torch.from_numpy(x[0]), t, s).numpy(), want[0])
