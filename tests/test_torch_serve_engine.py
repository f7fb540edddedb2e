"""The port's continuous-batching engine against the JAX package's (CPU).

Greedy tokens and the device-step statistics must equal the JAX engine's on
the same weights and requests: c2i with adapter features on 2 slots with 5
requests and quantum 5, the int8 cache, and t2i with left-padded caption
masks (the JAX suite's `test_serve_engine.py` and `test_serve_t2i.py`, run
here in both packages). Then the port's own invariants: sampled tokens do not
depend on overlapped admission, greedy tokens not on the quantum buckets,
and a request's tokens not on its neighbour.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu.config import GPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.serve.engine import Request as JRequest
from controlar_tpu.serve.engine import ServeConfig as JServeConfig
from controlar_tpu.serve.engine import ServeEngine as JServeEngine
from controlar_tpu_torch import convert
from controlar_tpu_torch.cells import serve_requests, serve_staggered
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.serve import Request, ServeConfig, ServeEngine

C2I = dict(model_type="c2i", dim=64, n_layer=4, n_head=2, cls_token_num=1, block_size=16,
           vocab_size=128, num_classes=10)
T2I = dict(model_type="t2i", dim=64, n_layer=4, n_head=2, cls_token_num=120, block_size=16,
           vocab_size=128, caption_dim=48)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _pair(kw, key):
    cfg = GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(key), cfg)
    if cfg.model_type == "t2i":  # the t2i head is zero at init: give it weights
        params["output"] = jax.random.normal(jax.random.PRNGKey(9),
                                             params["output"].shape) * 0.5
    tcfg = TGPTConfig(**kw)
    return cfg, params, tcfg, convert.gpt_from_jax(_np_tree(params), tcfg)


def _requests(kind, n, rng, cfg, cls=Request):
    reqs = []
    for i in range(n):
        kw = dict(request_id=i, cfg_scale=2.0)
        if kind["model_type"] == "c2i":
            kw["label"] = int(rng.integers(0, 10))
        else:
            kw["caption_emb"] = rng.standard_normal((cfg.cls_token_num, 48)).astype(np.float32)
            mask = np.ones(cfg.cls_token_num, bool)
            mask[: (50, 0, 100)[i % 3]] = False  # left padding
            kw["emb_mask"] = mask
        if kind.get("features"):
            kw["adapter_features"] = (rng.standard_normal((cfg.block_size, 384)) * 0.1
                                      ).astype(np.float32)
        reqs.append(cls(**kw))
    return reqs


# name: (model, key, requests, max_slots, quantum, JAX cache dtype, the port's, features)
JAX_CASES = {
    "c2i_control_2slots_5req": (C2I, 0, 5, 2, 5, jnp.float32, torch.float32, True),
    "c2i_int8_cache": (C2I, 1, 3, 2, 5, jnp.int8, torch.int8, False),
    "t2i_left_padded": (T2I, 0, 3, 2, 7, jnp.float32, torch.float32, True),
}


@pytest.fixture(scope="module", params=list(JAX_CASES))
def jax_run(request):
    """One JAX engine run per case, shared by the tests of this module."""
    kind, key, n, slots, quantum, jdt, tdt, feats = JAX_CASES[request.param]
    kind = dict(kind, features=feats)
    cfg, params, tcfg, model = _pair({k: v for k, v in kind.items() if k != "features"}, key)
    jreqs = _requests(kind, n, np.random.default_rng(key), cfg, JRequest)
    eng = JServeEngine(params, cfg, JServeConfig(max_slots=slots, quantum=quantum, greedy=True,
                                                 top_k=0, cache_dtype=jdt, use_flash=False))
    done = eng.run(jreqs)
    return dict(kind=kind, key=key, n=n, tcfg=tcfg, model=model, slots=slots, quantum=quantum,
                tdt=tdt, tokens=[r.tokens for r in done], stats=dict(eng.stats))


@pytest.mark.parametrize("use_flash", [False, True])
def test_engine_greedy_tokens_and_stats_match_jax(jax_run, use_flash):
    """use_flash=False takes the same masked attention as the JAX engine;
    use_flash=True takes the kernels' plain versions (q rounded to bf16 as
    the kernels read it) and the per-slot append, and keeps the tokens."""
    r = jax_run
    reqs = _requests(r["kind"], r["n"], np.random.default_rng(r["key"]), r["tcfg"])
    eng = ServeEngine(r["model"], r["tcfg"], ServeConfig(
        max_slots=r["slots"], quantum=r["quantum"], greedy=True, top_k=0,
        cache_dtype=r["tdt"], use_flash=use_flash), device="cpu")
    done = eng.run(reqs)
    assert [d.request_id for d in done] == list(range(r["n"]))
    assert len(np.unique(np.concatenate(r["tokens"]))) > 4  # a real token stream
    for got, want in zip(done, r["tokens"]):
        assert got.tokens.shape == (r["tcfg"].block_size,) and got.tokens.dtype == np.int32
        np.testing.assert_array_equal(got.tokens, want)
        assert got.t_done >= got.t_submit
    assert eng.stats == r["stats"]


def _c2i_model(key=0):
    _, params, tcfg, model = _pair(C2I, key)
    return params, tcfg, model


def test_pick_quantum_matches_jax():
    """The occupancy policy's selection on the JAX suite's states."""
    params, tcfg, model = _c2i_model()
    kw = dict(max_slots=4, quantum=8, greedy=True, quantum_buckets=(8, 4, 2),
              quantum_policy="occupancy", use_flash=False)
    eng = ServeEngine(model, tcfg, ServeConfig(**kw), device="cpu")
    jeng = JServeEngine(params, GPTConfig(**C2I), JServeConfig(**kw))
    states = [([0], {0: 0}, 2), ([0, 1], {0: 0, 1: 0}, 4), ([0, 1, 2, 3], {}, 8),
              ([0, 1, 2, 3], {2: tcfg.block_size - 3}, 4)]
    for active, emitted, want in states:
        for e in (eng, jeng):
            e.active[:] = False
            e.active[active] = True
            e.emitted[:] = 0
            for s, v in emitted.items():
                e.emitted[s] = v
        assert eng._pick_quantum() == jeng._pick_quantum() == want
    eng.active[:] = False
    assert ServeEngine(model, tcfg, ServeConfig(max_slots=2, quantum=6), device="cpu"
                       )._pick_quantum() == 6


def _staggered(model, tcfg, overlap, n_req=7):
    eng = ServeEngine(model, tcfg, ServeConfig(
        max_slots=2, quantum=5, top_k=8, cache_dtype=torch.float32, use_flash=True,
        overlap_admission=overlap, overlap_depth=2), device="cpu")
    reqs = serve_requests(n_req, num_classes=10, cfg_scale=2.0)
    for r in reqs:
        r.seed += 100
    return serve_staggered(eng, reqs, upfront=3, add_after_step=2), dict(eng.stats)


def test_overlap_admission_matches_sync():
    """Sampled (top_k=8) tokens and the step accounting are identical with
    overlapped admission: both admit the same groups at the same steps."""
    _, tcfg, model = _c2i_model(1)
    done_s, stats_s = _staggered(model, tcfg, False)
    done_o, stats_o = _staggered(model, tcfg, True)
    assert len(done_s) == len(done_o) == 7
    for a, b in zip(done_s, done_o):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert stats_s == stats_o
    assert not np.array_equal(done_s[0].tokens, done_s[1].tokens)


@pytest.mark.parametrize("policy,slots,n_req", [("early_exit", 2, 3), ("occupancy", 4, 6)])
def test_quantum_buckets_keep_greedy_tokens(policy, slots, n_req):
    """Buckets change the schedule (and so the prefill groups), never a
    request's greedy tokens; early exit wastes no more device steps."""
    _, tcfg, model = _c2i_model()

    def run(buckets):
        eng = ServeEngine(model, tcfg, ServeConfig(
            max_slots=slots, quantum=8, greedy=True, quantum_buckets=buckets,
            quantum_policy=policy, use_flash=False), device="cpu")
        reqs = [Request(request_id=i, label=i, cfg_scale=2.0, seed=i) for i in range(n_req)]
        return eng.run(reqs), dict(eng.stats)

    done_b, stats_b = run((8, 4, 2))
    done_f, stats_f = run(None)
    for a, b in zip(done_b, done_f):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # the first token of each request is emitted at admission (prefill)
    assert stats_b["useful_steps"] == stats_f["useful_steps"] == n_req * (tcfg.block_size - 1)
    assert stats_b["slot_steps"] <= stats_f["slot_steps"]


def test_slot_isolation():
    """Request 0 alone, and with a neighbour admitted one step() later (so
    both runs admit request 0 in a group of one): its sampled tokens are
    bit-identical, through the kernels' plain versions and the per-slot
    append."""
    _, tcfg, model = _c2i_model()

    def run(with_neighbour):
        eng = ServeEngine(model, tcfg, ServeConfig(max_slots=2, quantum=6, top_k=8,
                                                   use_flash=True), device="cpu")
        reqs = serve_requests(2 if with_neighbour else 1, num_classes=10, cfg_scale=2.0)
        return serve_staggered(eng, reqs, upfront=1, add_after_step=1)

    solo, duo = run(False), run(True)
    assert solo[0].tokens.shape == (tcfg.block_size,)
    np.testing.assert_array_equal(solo[0].tokens, duo[0].tokens)
    assert not np.array_equal(duo[0].tokens, duo[1].tokens)


def test_stacked_cache_is_not_ported():
    """kv_stacked=True keeps one stacked (L, 2 * slots, S, W) cache, not the
    flat engine's per-layer list."""
    _, tcfg, model = _c2i_model()
    eng = ServeEngine(model, tcfg, ServeConfig(max_slots=2, kv_stacked=True), device="cpu")
    assert isinstance(eng.caches, torch.Tensor)
    assert eng.caches.shape == (tcfg.n_layer, 4, eng.s_max, 2 * tcfg.dim)
    flat = ServeEngine(model, tcfg, ServeConfig(max_slots=2), device="cpu")
    assert isinstance(flat.caches, list) and len(flat.caches) == tcfg.n_layer
