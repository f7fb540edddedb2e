"""`eval/quant_report.measure_quant_agreement` of the port against the JAX
package's, on the CPU at a tiny c2i configuration (the one of
`tests/test_quant.py`'s gate), each mode its own case.

The base model is fp32 in both packages, so the bf16-free greedy rollouts are
token for token the same, and both quantize the same weights to the same
int8 / int4 carriers. The sampled agreement gets the JAX package's own
Gumbel draw (`jax.random.gumbel(PRNGKey(17), ...)`) passed in as a tensor.
What may differ, and by how much:
- teacher-forced agreement and its per-position profile: a position flips
  only where its top-2 logits are within the ~1e-6 relative that the other
  order of fp32 sums moves them; at most one of the 256 positions (two under
  the int4 cache, where a cache value's rounding can flip with its scale's
  last bit). At this seed none differs.
- max_rel_logit_err: 1e-3 relative, 1e-5 absolute (fp32 sums in another
  order over three layers; the int4 cache's rounding).
- greedy free-running metrics: equal, since the rollouts are (a flip would
  change every later token; none occurs at this seed).
- sampled free-running metrics: not compared (the two packages' RNGs draw
  different numbers); only their range is checked.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu.config import GPTConfig
from controlar_tpu.eval import quant_report as jqr
from controlar_tpu.models import gpt as jgpt
from controlar_tpu_torch import convert
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.eval import quant_report as tqr

KW = dict(model_type="c2i", dim=128, n_layer=3, n_head=4, cls_token_num=1, block_size=64,
          vocab_size=512, num_classes=16)
N_NEW, ROWS = 64, 4
POSITIONS = N_NEW * ROWS
FLIPS = {"w4+kv4": 2}  # teacher-forced positions that may differ; 1 elsewhere


@pytest.fixture(scope="module")
def reports():
    cfg = GPTConfig(**KW)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    want = jqr.measure_quant_agreement(params, cfg, modes=tqr.MODES, max_new_tokens=N_NEW)
    gumbel = np.array(jax.random.gumbel(jax.random.PRNGKey(17), (ROWS, N_NEW, KW["vocab_size"]),
                                        jnp.float32))
    model = convert.gpt_from_jax(jax.tree.map(np.asarray, params), TGPTConfig(**KW))
    parts = []
    got = tqr.measure_quant_agreement(model, TGPTConfig(**KW), modes=tqr.MODES,
                                      max_new_tokens=N_NEW, gumbel=torch.from_numpy(gumbel),
                                      device="cpu", on_mode=parts.append)
    assert parts == ["bf16", *tqr.MODES]
    # the model is left as it was: unquantized
    assert type(model.layers[0].wqkv) is torch.nn.Linear
    return want, got


@pytest.mark.parametrize("mode", tqr.MODES)
def test_mode_matches_jax(reports, mode):
    want, got = reports
    w, g = want[mode], got[mode]
    assert set(g) == set(w)
    flips = FLIPS.get(mode, 1)
    for key in ("teacher_forced_agreement", "sampled_agreement"):
        assert abs(g[key] - w[key]) <= flips / POSITIONS, (key, g[key], w[key])
    third = POSITIONS // 3
    np.testing.assert_allclose(g["pos_agree_thirds"], w["pos_agree_thirds"],
                               atol=flips / third)
    assert abs(g["pos_agree_min"] - w["pos_agree_min"]) <= flips / ROWS
    np.testing.assert_allclose(g["max_rel_logit_err"], w["max_rel_logit_err"], rtol=1e-3,
                               atol=1e-5)
    assert g["mean_prefix_survival"] == w["mean_prefix_survival"]
    assert g["free_running_match"] == w["free_running_match"]
    assert 0 <= g["sampled_free_match"] <= 1 and 0 <= g["sampled_survival"] <= N_NEW


def test_format_report_matches_jax(reports):
    want, got = reports
    assert tqr.format_report(got).splitlines()[0] == jqr.format_report(want).splitlines()[0]
    assert [ln.split()[0] for ln in tqr.format_report(got).splitlines()[1:]] == list(tqr.MODES)


def test_teacher_forced_logits_match_decode():
    """The scoring pass (prefill, one chunk over N - 1 tokens) gives the
    logits that prefill plus a decode step per token give."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.models import gpt as tgpt

    cfg = TGPTConfig(**KW)
    model = tgpt.init_gpt(cfg, seed=3)
    labels = torch.tensor([1, 5])
    tokens = torch.randint(0, KW["vocab_size"], (2, 12),
                           generator=torch.Generator().manual_seed(0))
    prefix = tgpt.embed_prefix_c2i(model, labels)
    got = tqr.teacher_forced_logits(model, cfg, prefix, tokens, torch.float32)
    caches = tdec.init_flat_caches(cfg, 2, 24, torch.float32)
    with torch.inference_mode():
        lg, caches = tdec.prefill_flat(model, cfg, caches, prefix, None, None)
        want = [lg]
        for i in range(11):
            lg, caches = tdec.decode_step_flat(model, cfg, caches, tokens[:, i], 1 + i, None,
                                               None, use_flash=False)
            want.append(lg)
    assert got.shape == (2, 12, KW["vocab_size"])
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(), atol=1e-4)


def test_unknown_mode_and_t2i_are_refused():
    cfg = TGPTConfig(**KW)
    from controlar_tpu_torch.models import gpt as tgpt

    model = tgpt.init_gpt(cfg, seed=0)
    with pytest.raises(ValueError, match="mode"):
        tqr.measure_quant_agreement(model, cfg, modes=("int3",), max_new_tokens=4,
                                    device="cpu")
    t2i = TGPTConfig(**{**KW, "model_type": "t2i", "cls_token_num": 4, "caption_dim": 16})
    with pytest.raises(ValueError, match="c2i"):
        tqr.measure_quant_agreement(tgpt.init_gpt(t2i), t2i, max_new_tokens=4, device="cpu")
