"""Tokenizer training in the port against the JAX package, fp32 on the CPU:
LPIPS, the PatchGAN and StyleGAN discriminators, the quantizer, GAN,
generator and discriminator losses with their gradients, two VQ train steps
across disc_start, the reconstruction evaluation, the converters and rename
tables, `train_vq` and its checkpoint.

Weights: one JAX tree each (numpy fills of the JAX package's shapes, or its
own init), carried into the port by `convert.*_from_jax`; inputs from numpy
seeds. Tiny configurations (a three-level VQ at 32 px, narrow LPIPS slices)
but for one forward of LPIPS at VGG16's widths.

Tolerances: forwards 1e-5 relative to the output's largest magnitude (fp32,
convolutions summed in another order); losses 1e-5 relative, floored at
0.1 (a mean of logits of either sign is near zero), after an update 1e-4;
gradients 2e-4 of each tensor's largest magnitude (fp32 backward through a
dozen convolutions and group norms; measured up to 1.1e-4), floored at 1e-2
of the model's largest; parameters after two AdamW steps (lr 1e-4) 1e-5
absolute for all but one element in 10^4, and every element within 2 lr a
step: Adam normalises each element's update, so an element whose gradient is
fp32 noise moves by up to lr either way in either package; the adaptive
weight 1e-4 relative; PSNR 1e-4, SSIM 1e-5 absolute; converters bit for bit.
The tokenizer has 64 channels (two a group-norm group, as VQ-16 has four):
with one channel a group, a bias just before a norm has no gradient in exact
arithmetic, only noise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controlar_tpu.config import VQConfig as JVQConfig
from controlar_tpu.convert.torch_lpips import convert_lpips_state_dicts
from controlar_tpu.eval.reconstruction import reconstruction_eval as jrecon_eval
from controlar_tpu.models import discriminators as jdisc
from controlar_tpu.models import lpips as jlpips
from controlar_tpu.models import vq as jvq
from controlar_tpu.train import optimizer as jopt
from controlar_tpu.train import vq_loss as jL
from controlar_tpu.train.vq_step import init_vq_train_state as jinit_vq_state
from controlar_tpu.train.vq_step import make_vq_train_step as jmake_vq_step
from controlar_tpu_torch import checkpoint, convert, convert_ref
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.eval import reconstruction as trecon
from controlar_tpu_torch.models import discriminators as tdisc
from controlar_tpu_torch.models import lpips as tlpips
from controlar_tpu_torch.train import optimizer as topt
from controlar_tpu_torch.train import vq_loss as tL
from controlar_tpu_torch.train import vq_step as tstep
from controlar_tpu_torch.train import vq_train

FWD_RTOL = 1e-5
LOSS_RTOL, LOSS_FLOOR = 1e-5, 0.1
GRAD_TOL, GRAD_FLOOR = 2e-4, 1e-2
PARAM_ATOL = 1e-5
ADAPTIVE_RTOL = 1e-4
PSNR_ATOL, SSIM_ATOL = 1e-4, 1e-5
LR = 1e-4

VQ_KW = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=64,
             encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2), num_res_blocks=1)
TINY_LPIPS = (4, 8, 8, 16, 16)
IMG = 32


def _x(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, rtol, what="", floor=1e-30):
    """|got - want| <= rtol x max(|want|.max(), floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max() / scale
    assert got.shape == want.shape and err <= rtol, f"{what}: {err} > {rtol}"


def _fill(shapes, seed):
    """numpy values for a JAX tree of shapes: weights uniform in
    +-1/sqrt(fan_in), norm scales near one, other leaves small."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key if hasattr(path[-1], "key") else None
        if leaf == "w":
            bound = 1 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


@functools.lru_cache(maxsize=None)
def _vq_tree(entropy=0.0, seed=0):
    cfg = JVQConfig(**VQ_KW, entropy_loss_ratio=entropy)
    params = _fill(jax.eval_shape(lambda: jvq.init_vq_params(jax.random.PRNGKey(0), cfg)), seed)
    params["codebook"] = jnp.asarray(
        np.random.default_rng(seed + 1).standard_normal(params["codebook"].shape), jnp.float32)
    return cfg, VQConfig(**VQ_KW, entropy_loss_ratio=entropy), params


def _lpips_tree(widths, seed=3):
    cins = [3] + [w for w, ids in zip(widths, tlpips.VGG_SLICES) for _ in ids]
    rng = np.random.default_rng(seed)
    vgg, k = {}, 0
    for w, ids in zip(widths, tlpips.VGG_SLICES):
        for i in ids:
            vgg[str(i)] = {"w": jnp.asarray(rng.standard_normal((3, 3, cins[k], w))
                                            / np.sqrt(9 * cins[k]), jnp.float32),
                           "b": jnp.asarray(0.05 * rng.standard_normal(w), jnp.float32)}
            k += 1
    lins = [{"w": jnp.asarray(np.abs(rng.standard_normal((1, 1, w, 1))) * 0.01, jnp.float32)}
            for w in widths]
    return {"vgg": vgg, "lins": lins}


@functools.lru_cache(maxsize=None)
def _disc_tree(disc_type, seed=4, px=IMG):
    if disc_type == "stylegan":
        return jax.tree.map(jnp.asarray, jdisc.init_stylegan_disc_params(
            jax.random.PRNGKey(seed), image_size=px))
    params = jdisc.init_patchgan_params(jax.random.PRNGKey(seed), ndf=8, n_layers=3)
    # non-trivial batch-norm biases
    rng = np.random.default_rng(seed)
    for blk in params["blocks"]:
        blk["bn"]["bias"] = jnp.asarray(0.05 * rng.standard_normal(blk["bn"]["bias"].shape),
                                        jnp.float32)
    return params


def _port_disc(disc_type, tree):
    fn = convert.stylegan_disc_from_jax if disc_type == "stylegan" else convert.patchgan_from_jax
    return fn(tree)


def _jdisc_fwd(disc_type):
    return jax.jit(jdisc.stylegan_disc_forward if disc_type == "stylegan"
                   else jdisc.patchgan_forward)


def _sd(module):
    return {n: t.detach() for n, t in module.state_dict().items()}


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths,px", [(TINY_LPIPS, IMG), (tlpips.VGG16_WIDTHS, 16)])
def test_lpips_matches_jax(widths, px):
    tree = _lpips_tree(widths)
    x, y = _x((2, px, px, 3), 0), _x((2, px, px, 3), 1)
    want = jax.jit(jlpips.lpips)(tree, jnp.asarray(x), jnp.asarray(y))
    got = tlpips.lpips(convert.lpips_from_jax(tree), torch.from_numpy(x), torch.from_numpy(y))
    _close(got.numpy(), np.asarray(want), FWD_RTOL, "lpips")


@pytest.mark.parametrize("disc_type", ["patchgan", "stylegan"])
def test_discriminator_forward_matches_jax(disc_type):
    tree = _disc_tree(disc_type)
    x = _x((3, IMG, IMG, 3), 2)
    want = _jdisc_fwd(disc_type)(tree, jnp.asarray(x))
    got = tdisc.disc_forward(_port_disc(disc_type, tree), disc_type, torch.from_numpy(x))
    _close(got.detach().numpy(), np.asarray(want), FWD_RTOL, disc_type)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_quantize_with_losses_matches_jax():
    """entropy_loss_ratio > 0: the three losses, the indices and z_q, and the
    gradients of their sum with respect to z and the codebook."""
    jcfg, tcfg, params = _vq_tree(entropy=0.1)
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 8)).astype(np.float32)

    def jtotal(cb, zz):
        zq, _, (a, b, c) = jL.quantize_with_losses({"codebook": cb}, jcfg, zz)
        return a + b + c + jnp.sum(zq * 0.3), (zq, a, b, c)

    (_, (jzq, *jlosses)), (jgcb, jgz) = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(params["codebook"], jnp.asarray(z))
    _, jidx, _ = jL.quantize_with_losses({"codebook": params["codebook"]}, jcfg, jnp.asarray(z))
    vq = convert.vq_from_jax(params, tcfg)
    vq.codebook.requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    zq, idx, losses = tL.quantize_with_losses(vq, tcfg, tz)
    total = sum(losses) + torch.sum(zq * 0.3)
    gcb, gz = torch.autograd.grad(total, [vq.codebook, tz])
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert float(losses[2].detach()) != 0.0
    for got, want, what in zip(losses, jlosses, ("vq", "commit", "entropy")):
        _close(got.detach().numpy(), np.asarray(want), LOSS_RTOL, what)
    _close(zq.detach().numpy(), np.asarray(jzq), FWD_RTOL, "z_q")
    _close(gcb.numpy(), np.asarray(jgcb), GRAD_TOL, "codebook grad")
    _close(gz.numpy(), np.asarray(jgz), GRAD_TOL, "z grad")


@pytest.mark.parametrize("name", ["hinge", "vanilla", "non-saturating"])
def test_d_losses_match_jax(name):
    real, fake = _x((2, 3, 3, 1), 6, -3, 3), _x((2, 3, 3, 1), 7, -3, 3)
    jfn = {"hinge": jL.hinge_d_loss, "vanilla": jL.vanilla_d_loss,
           "non-saturating": jL.non_saturating_d_loss}[name]
    want = jfn(jnp.asarray(real), jnp.asarray(fake))
    got = tL.D_LOSSES[name](torch.from_numpy(real), torch.from_numpy(fake))
    _close(got.numpy(), np.asarray(want), LOSS_RTOL, name)


@pytest.mark.parametrize("name", ["hinge", "non-saturating"])
def test_gen_losses_match_jax(name):
    fake = _x((2, 3, 3, 1), 8, -3, 3)
    jfn = jL.hinge_gen_loss if name == "hinge" else jL.non_saturating_gen_loss
    want = jfn(jnp.asarray(fake))
    _close(tL.GEN_LOSSES[name](torch.from_numpy(fake)).numpy(), np.asarray(want), LOSS_RTOL,
           name)


def test_adopt_weight():
    for step, threshold in ((0, 0), (3, 5), (5, 5), (9, 5)):
        assert tL.adopt_weight(0.5, step, threshold) == float(
            jL.adopt_weight(0.5, jnp.asarray(step), threshold))


def _px(disc_type):
    """StyleGAN's 512-channel blocks at 16 px (two blocks) in the generator
    and step tests, PatchGAN at 32. (The discriminator's own gradients are
    compared at 32 px: at 16 px the random StyleGAN's fp32 gradients differ
    from its fp64 ones by up to 1.6e-2 of their largest, both in the port.)"""
    return 16 if disc_type == "stylegan" else IMG


def _gen_setup(disc_type="patchgan"):
    jcfg, tcfg, vq_tree = _vq_tree()
    lp_tree = _lpips_tree(TINY_LPIPS)
    disc_tree = _disc_tree(disc_type, px=_px(disc_type))
    images = _x((2, _px(disc_type), _px(disc_type), 3), 9)
    return (jcfg, tcfg, vq_tree, lp_tree, disc_tree, images,
            convert.vq_from_jax(vq_tree, tcfg).requires_grad_(True),
            convert.lpips_from_jax(lp_tree), _port_disc(disc_type, disc_tree))


def _grads_close(got: dict, want: dict, what):
    """Each gradient within GRAD_TOL of its largest magnitude, floored at
    GRAD_FLOOR of the model's largest gradient: a tensor whose gradient is
    zero in exact arithmetic (a bias just before a group norm of one
    channel a group) holds fp32 noise of the order of the others'."""
    assert set(got) == set(want), what
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for n, g in got.items():
        scale = max(float(want[n].abs().max()), floor)
        err = float((g - want[n]).abs().max()) / scale
        assert err <= GRAD_TOL, f"{what} {n}: {err} > {GRAD_TOL}"


@pytest.mark.parametrize("disc_type,adaptive,rec", [("patchgan", False, "l2"),
                                                    ("patchgan", True, "l1"),
                                                    ("stylegan", True, "l2")])
def test_generator_loss_matches_jax(disc_type, adaptive, rec):
    """Value, metrics (the adaptive weight included) and the gradients with
    respect to every tokenizer parameter, past disc_start."""
    jcfg, tcfg, vq_tree, lp_tree, disc_tree, images, vq, lp, disc = _gen_setup(disc_type)
    kw = dict(disc_weight=0.5, rec_loss_type=rec, disc_type=disc_type,
              disc_adaptive_weight=adaptive)

    def jloss(vp):
        loss, (m, _) = jL.generator_loss(vp, disc_tree, lp_tree, jcfg, jnp.asarray(images),
                                         jnp.asarray(10), 5, **kw)
        return loss, m

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(vq_tree)
    tl, (tm, recon) = tL.generator_loss(vq, disc, lp, tcfg, torch.from_numpy(images), 10, 5,
                                        **kw)
    params = dict(vq.named_parameters())
    tg = dict(zip(params, torch.autograd.grad(tl, list(params.values()))))
    _close(tl.detach().numpy(), np.asarray(jl), LOSS_RTOL, "loss", LOSS_FLOOR)
    for k, v in jm.items():
        rtol = ADAPTIVE_RTOL if k == "disc_adaptive_weight" else LOSS_RTOL
        _close(tm[k].detach().numpy(), np.asarray(v), rtol, k, LOSS_FLOOR)
    if not adaptive:
        assert float(tm["disc_adaptive_weight"]) == 1.0
    assert recon.shape == images.shape
    _grads_close(tg, _sd(convert.vq_from_jax(jax.tree.map(np.asarray, jg), tcfg)), "vq grad")


def test_adaptive_weight_on_the_last_weight_alone():
    """The weight is the norm ratio of the NLL's and the adversarial loss's
    gradients at conv_out's weight, clipped at 1e4."""
    _, tcfg, _, _, _, images, vq, lp, disc = _gen_setup()
    _, (m, recon) = tL.generator_loss(vq, disc, lp, tcfg, torch.from_numpy(images), 10, 0,
                                      disc_adaptive_weight=True)
    w = vq.decoder.conv_out.weight
    x = torch.from_numpy(images)
    nll = torch.mean((x - recon) ** 2) + torch.mean(tlpips.lpips(lp, x, recon))
    adv = tL.hinge_gen_loss(tdisc.patchgan_forward(disc, recon))
    g_nll, = torch.autograd.grad(nll, w, retain_graph=True)
    g_adv, = torch.autograd.grad(adv, w, retain_graph=True)
    want = g_nll.norm() / (g_adv.norm() + 1e-4)
    np.testing.assert_allclose(float(m["disc_adaptive_weight"]), float(want), rtol=1e-6)
    assert float(tL.calculate_adaptive_weight(1e9 * nll, adv, w)) == 1e4
    assert not tL.calculate_adaptive_weight(nll, adv, w).requires_grad


@pytest.mark.parametrize("disc_type,loss_type,step", [("patchgan", "hinge", 10),
                                                      ("patchgan", "vanilla", 2),
                                                      ("stylegan", "non-saturating", 10)])
def test_discriminator_loss_matches_jax(disc_type, loss_type, step):
    """Before disc_start (step 2 < 5) the loss is zero with zero gradients."""
    disc_tree = _disc_tree(disc_type)
    images, recon = _x((2, IMG, IMG, 3), 10), _x((2, IMG, IMG, 3), 11)

    def jloss(dp):
        return jL.discriminator_loss(dp, jnp.asarray(images), jnp.asarray(recon),
                                     jnp.asarray(step), 5, 0.5, disc_loss_type=loss_type,
                                     disc_type=disc_type)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(disc_tree)
    disc = _port_disc(disc_type, disc_tree)
    tl = tL.discriminator_loss(disc, torch.from_numpy(images), torch.from_numpy(recon), step, 5,
                               0.5, disc_loss_type=loss_type, disc_type=disc_type)
    params = dict(disc.named_parameters())
    tg = dict(zip(params, torch.autograd.grad(tl, list(params.values()), allow_unused=True)))
    _close(tl.detach().numpy(), np.asarray(jl), LOSS_RTOL, "loss", LOSS_FLOOR)
    want = _sd(_port_disc(disc_type, jax.tree.map(np.asarray, jg)))
    if step < 5:
        assert float(tl.detach()) == 0.0 and all(float(g.abs().max()) == 0.0 for g in tg.values())
        return
    _grads_close(tg, want, "disc grad")


def test_decay_mask_matches_jax():
    """The port's weight-decay rule on the tokenizer's and both
    discriminators' parameters equals the JAX package's leaf by leaf; no
    name matches the per-layer rule."""
    trees = {"vq": (_vq_tree()[2], lambda t: convert.vq_from_jax(t, _vq_tree()[1])),
             "patchgan": (_disc_tree("patchgan"), convert.patchgan_from_jax),
             "stylegan": (_disc_tree("stylegan"), convert.stylegan_disc_from_jax)}
    for name, (tree, to_port) in trees.items():
        # the JAX mask as a tree of constant arrays of the leaves' shapes
        jmask = jax.tree.map(lambda m, t: np.full(np.shape(t), float(m), np.float32),
                             jopt.decay_mask(tree), tree)
        mask_sd = _sd(to_port(jmask))
        module = to_port(jax.tree.map(np.asarray, tree))
        got = topt.decay_mask(dict(module.named_parameters()))
        want = {n: bool(mask_sd[n].reshape(-1)[0]) for n in got}
        assert got == want, name
        assert not any(topt._PER_LAYER.search(n) for n in got), name


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("disc_type", ["patchgan", "stylegan"])
def test_two_vq_steps_across_disc_start_match_jax(disc_type):
    """disc_start 1: the first step's adversarial terms are held at zero, the
    second's are live; adaptive weight and EMA on. The tokenizer's and the
    discriminator's parameters and the EMA after both steps."""
    jcfg, tcfg, vq_tree, lp_tree, disc_tree, _, vq, lp, disc = _gen_setup(disc_type)
    images = _x((2, _px(disc_type), _px(disc_type), 3), 12)
    kw = dict(disc_start=1, disc_weight=0.5, ema_decay=0.9, disc_type=disc_type,
              disc_adaptive_weight=True)
    jtx_g = jopt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    jtx_d = jopt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    jstate = jinit_vq_state(vq_tree, disc_tree, jtx_g, jtx_d, use_ema=True)
    jfn = jax.jit(jmake_vq_step(jcfg, jtx_g, jtx_d, lp_tree, **kw))
    ttx_g = topt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    ttx_d = topt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    tstate = tstep.init_vq_train_state(vq, disc, ttx_g, ttx_d, use_ema=True)
    tfn = tstep.make_vq_train_step(tcfg, ttx_g, ttx_d, lp, **kw)
    for i in range(2):
        jstate, jm = jfn(jstate, jnp.asarray(images))
        tstate, tm = tfn(vq, disc, tstate, torch.from_numpy(images))
        for k in ("g_loss", "d_loss", "rec_loss", "disc_adaptive_weight"):
            rtol = ADAPTIVE_RTOL if k == "disc_adaptive_weight" or i else LOSS_RTOL
            _close(tm[k].numpy(), np.asarray(jm[k]), rtol, f"{k}, step {i}", LOSS_FLOOR)
    assert float(tm["d_loss"]) != 0.0 and tstate.step == 2
    pairs = ((_sd(vq), _sd(convert.vq_from_jax(jax.tree.map(np.asarray, jstate.vq_params),
                                              tcfg)), "vq"),
             (tstate.ema_params, _sd(convert.vq_from_jax(
                 jax.tree.map(np.asarray, jstate.ema_params), tcfg)), "ema"),
             (_sd(disc), _sd(_port_disc(disc_type, jax.tree.map(np.asarray,
                                                                jstate.disc_params))), "disc"))
    for got, want, what in pairs:
        diff = torch.cat([(got[n] - t).abs().flatten() for n, t in want.items()])
        worst = max(want, key=lambda n: float((got[n] - want[n]).abs().max()))
        assert float(diff.max()) <= 2 * LR * 2, f"{what}: {worst} off by {float(diff.max())}"
        assert float((diff > PARAM_ATOL).float().mean()) <= 1e-4, what


def test_adamw_on_zero_gradients_matches_optax():
    """Before disc_start the discriminator's loss is held at zero, so its
    gradients are all zero: the global-norm clip must select them (not
    divide 0 by 0) and AdamW still decays the weights, as optax does."""
    tree = _disc_tree("patchgan")
    zeros = jax.tree.map(jnp.zeros_like, tree)
    jtx = jopt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    upd, _ = jtx.update(zeros, jtx.init(tree), tree)
    want = _sd(_port_disc("patchgan", jax.tree.map(np.asarray, optax_apply(tree, upd))))
    disc = _port_disc("patchgan", tree)
    params = dict(disc.named_parameters())
    ttx = topt.make_optimizer(lr=LR, beta1=0.9, beta2=0.95)
    _, norm = ttx.step(params, {n: torch.zeros_like(p) for n, p in params.items()},
                       ttx.init(params))
    assert float(norm) == 0.0
    for n, t in _sd(disc).items():
        assert torch.isfinite(t).all(), n
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-9, err_msg=n)
    assert not torch.equal(params["conv_in.weight"], _sd(_port_disc("patchgan", tree))[
        "conv_in.weight"])  # decayed


def optax_apply(params, updates):
    return jax.tree.map(lambda p, u: p + u, params, updates)


# ---------------------------------------------------------------------------
# reconstruction evaluation, converters, train_vq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("px", [IMG, 176])  # single-scale SSIM; MS-SSIM at 176 px
def test_reconstruction_eval_matches_jax(px, tmp_path):
    jcfg, tcfg, vq_tree = _vq_tree()
    imgs = np.random.default_rng(13).integers(0, 256, (4, px, px, 3)).astype(np.uint8)
    want = jrecon_eval(vq_tree, jcfg, [imgs[:3], imgs[3:]])
    got = trecon.reconstruction_eval(convert.vq_from_jax(vq_tree, tcfg), tcfg,
                                     [imgs[:3], imgs[3:]], out_dir=str(tmp_path), device="cpu")
    assert got["count"] == want["count"] == 4
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(got["ms_ssim"], want["ms_ssim"], rtol=0, atol=SSIM_ATOL)
    samples = np.load(tmp_path / "samples.npz")["arr_0"]
    assert samples.shape == (4, px, px, 3) and samples.dtype == np.uint8
    for i in range(4):
        assert np.array_equal(np.asarray(Image.open(tmp_path / "orig" / f"{i}.png")), imgs[i])
        assert np.array_equal(np.asarray(Image.open(tmp_path / "recon" / f"{i}.png")),
                              samples[i])
    assert trecon.psnr(imgs[0], imgs[0]) == float("inf")


def test_lpips_converters_bit_for_bit():
    """torchvision's vgg16 state dict and the heads' file -> the JAX
    package's converter -> convert.lpips_from_jax, and through the rename
    table; and back."""
    rng = np.random.default_rng(14)
    port = convert.lpips_from_jax(_lpips_tree(TINY_LPIPS))
    vgg_sd, lin_sd = convert_ref.lpips_reference_state_dicts(port)
    vgg_sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in vgg_sd.items()}
    vgg_sd["features.30.weight"] = torch.zeros(1)  # a key the port does not read
    lin_sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in lin_sd.items()}
    a = _sd(convert.lpips_from_jax(convert_lpips_state_dicts(vgg_sd, lin_sd)))
    b = _sd(convert_ref.lpips_from_state_dicts(vgg_sd, lin_sd, device="cpu"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    v2, l2 = convert_ref.lpips_reference_state_dicts(convert_ref.lpips_from_state_dicts(
        vgg_sd, lin_sd, device="cpu"))
    assert all(torch.equal(v2[k], vgg_sd[k]) for k in v2)
    assert all(torch.equal(l2[k], lin_sd[k]) for k in l2) and len(l2) == 5


@pytest.mark.parametrize("disc_type", ["patchgan", "stylegan"])
def test_discriminator_converters_bit_for_bit(disc_type):
    """A reference-layout state dict (PatchGAN with batch-norm running
    statistics, which are not read) -> the JAX package's converter ->
    convert.*_from_jax, and through the rename table; and back."""
    rng = np.random.default_rng(15)
    port = _port_disc(disc_type, _disc_tree(disc_type))
    if disc_type == "stylegan":
        ref = convert_ref.stylegan_disc_reference_state_dict(port)
    else:
        ref = convert_ref.patchgan_reference_state_dict(port)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in ref.items()}
    if disc_type == "stylegan":
        jtree = jdisc.convert_stylegan_disc_state_dict(sd)
        b = convert_ref.stylegan_disc_from_state_dict(sd, device="cpu")
        back = convert_ref.stylegan_disc_reference_state_dict(b)
    else:
        extra = {"main.3.running_mean": torch.zeros(16), "main.3.num_batches_tracked":
                 torch.zeros((), dtype=torch.int64)}
        jtree = jdisc.convert_patchgan_state_dict({**sd, **extra}, n_layers=3)
        b = convert_ref.patchgan_from_state_dict({**sd, **extra}, device="cpu")
        back = convert_ref.patchgan_reference_state_dict(b)
    a, bb = _sd(_port_disc(disc_type, jtree)), _sd(b)
    assert a.keys() == bb.keys() and all(torch.equal(a[k], bb[k]) for k in a)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    assert all(p.requires_grad for p in b.parameters())
    x = _x((2, IMG, IMG, 3), 16)
    want = _jdisc_fwd(disc_type)(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x))
    _close(tdisc.disc_forward(b, disc_type, torch.from_numpy(x)).detach().numpy(),
           np.asarray(want), FWD_RTOL, "forward")


def test_train_vq_checkpoint_and_eval(tmp_path, monkeypatch):
    """Two steps of `train_vq` on a folder of PNGs (a tiny tokenizer in place
    of VQ-16), a checkpoint with the EMA, which `load_vq_checkpoint` reads
    before the live parameters, and the reconstruction gate's files."""
    monkeypatch.setattr(vq_train, "vq_config", lambda name: VQConfig(**VQ_KW))
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(17)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)).save(
            folder / f"{i}.png")
    (folder / "notes.txt").write_text("not an image")
    out = vq_train.train_vq(str(folder), image_size=IMG, batch_size=2, max_steps=2,
                            disc_start=1, disc_adaptive_weight=True, ema=True, log_every=1,
                            ckpt_every=2, eval_after=3, results_dir=str(tmp_path / "run"),
                            device="cpu", log=lambda m: None)
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(list(h.values())).all() for h in out["history"])
    assert out["eval"]["count"] == 3 and np.isfinite(out["eval"]["psnr"])
    assert np.load(tmp_path / "run" / "recon_eval" / "samples.npz")["arr_0"].shape == (
        3, IMG, IMG, 3)
    ckpt = tmp_path / "run" / "vq_checkpoints"
    loaded = checkpoint.load_vq_checkpoint(str(ckpt), VQConfig(**VQ_KW), device="cpu")
    state = out["state"]
    assert all(torch.equal(t, state.ema_params[n]) for n, t in _sd(loaded).items())
    assert not torch.equal(state.ema_params["codebook"], state.vq_params["codebook"])
    saved = torch.load(ckpt / "step_00000002" / "state.pt", weights_only=True)
    assert saved["step"] == 2 and set(saved["disc_params"]) == set(state.disc_params)
