"""The port's training attention (`ops/flash_train.py`) against the JAX
package's Pallas training kernel (`flash_attention_train_pallas`, interpret
mode on the CPU) and its `jax.vjp`, on the same numpy inputs.

The kernels have no diagonal exception: rows whose keys are all masked (the
left-padded caption rows) are finite junk whose value depends on the tiles
a kernel visits, so outputs are compared on the other rows and gradients
under a cotangent that is zero on them, as in the model (their output
reaches no kept logit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu_torch.ops import flash_train as ft

# The port rounds p to bf16 against the row max, the Pallas kernel against
# the running max of its 16-key tiles (each 2**-9 relative), and both round
# q, k, v and ds to bf16 after fp32 sums in another order: agreement to a
# few 1e-3 at |out|, |grad| ~ 1; a dropped tile or a misapplied bias moves
# them by O(0.1).
ATOL, RTOL = 5e-3, 1e-2

CASES = [  # b, t, h, d, left padding of each row (None: causal only)
    (2, 70, 3, 16, None),
    (2, 70, 3, 16, (7, 3)),
    (1, 37, 2, 100, (5,)),
]


def _inputs(b, t, h, d, pads, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    kv = np.ones((b, t), bool)
    for i, p in enumerate(pads or ()):
        kv[i, :p] = False
    co = rng.standard_normal((b, t, h, d)).astype(np.float32) * kv[:, :, None, None]
    return q, k, v, (kv if pads else None), co


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=["causal", "left_padded", "d100"])
def test_plain_versions_match_pallas_kernel_and_vjp(case):
    b, t, h, d, pads = case
    q, k, v, kv, co = _inputs(b, t, h, d, pads, seed=t + d)
    jkv = None if kv is None else jnp.asarray(kv)

    def f(q_, k_, v_):
        return jftp.flash_attention_train_pallas(q_, k_, v_, jkv, q_block=32, k_block=16,
                                                 interpret=True)

    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(co))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ft.flash_attention_train(tq, tk, tv, None if kv is None else torch.from_numpy(kv))
    out.backward(torch.from_numpy(co))
    rows = np.ones((b, t), bool) if kv is None else kv
    _close(out.detach().numpy() * rows[:, :, None, None],
           np.asarray(want) * rows[:, :, None, None], "out")
    for got, want_g, name in zip((tq, tk, tv), want_grads, "qkv"):
        _close(got.grad.numpy(), np.asarray(want_g), f"d{name}")

    # lse against the Pallas forward's, on its inputs padded to its tiles
    t_pad = 32 * ((t + 31) // 32)
    s_pad = 16 * ((t + 15) // 16)
    jbias = np.full((b, s_pad), -1e9, np.float32)
    jbias[:, :t] = 0.0 if kv is None else np.where(kv, 0.0, -1e9)
    pad = [(0, 0), (0, t_pad - t), (0, 0), (0, 0)]
    padk = [(0, 0), (0, s_pad - t), (0, 0), (0, 0)]
    _, jlse = jftp._fwd(jnp.pad(jnp.asarray(q), pad), jnp.pad(jnp.asarray(k), padk),
                        jnp.pad(jnp.asarray(v), padk), jnp.asarray(jbias), 32, 16, True)
    _, lse = ft.flash_train_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), ft.key_bias(
                                        None if kv is None else torch.from_numpy(kv)))
    lrows = np.broadcast_to(rows[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[lrows], np.asarray(jlse)[:, :, :t][lrows],
                               rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_stay_finite():
    b, t, h, d = 2, 40, 2, 16
    q, k, v, kv, _ = _inputs(b, t, h, d, (9, 40), seed=0)  # row 1: every key masked
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ft.flash_attention_train(tq, tk, tv, torch.from_numpy(kv))
    out.pow(2).sum().backward()  # a cotangent on the junk rows too
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x.grad).all() for x in (tq, tk, tv))
    _, lse = ft.flash_train_fwd_ref(tq, tk, tv, ft.key_bias(torch.from_numpy(kv)))
    assert torch.isfinite(lse).all()


def test_cpu_wrapper_takes_the_plain_versions_and_counts_nothing():
    b, t, h, d = 2, 33, 2, 16
    q, k, v, kv, co = _inputs(b, t, h, d, (4, 0), seed=1)
    kernels = (ft.flash_train_fwd, ft.flash_train_dq, ft.flash_train_dkv)
    before = [f.launches for f in kernels]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    bias = ft.key_bias(torch.from_numpy(kv))
    out = ft.flash_attention_train(tq, tk, tv, torch.from_numpy(kv))
    out.backward(torch.from_numpy(co))
    assert [f.launches for f in kernels] == before
    want, lse = ft.flash_train_fwd_ref(tq.detach(), tk.detach(), tv.detach(), bias)
    assert torch.equal(out.detach(), want)
    delta = (torch.from_numpy(co) * want).sum(-1).transpose(1, 2)
    grads = ft.flash_train_bwd_ref(tq.detach(), tk.detach(), tv.detach(), bias,
                                   torch.from_numpy(co), lse, delta)
    for x, g in zip((tq, tk, tv), grads):
        assert torch.equal(x.grad, g)
    with pytest.raises(ValueError, match="unsupported device"):
        ft.flash_train_fwd(*(x.detach().to("meta") for x in (tq, tk, tv)))
