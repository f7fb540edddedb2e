"""The plain reference against the port at tiny widths on the CPU, on the
benchmark's own seed-made weights handed to the port's loaders."""
import pytest
import torch

from portbench.harness import program, traffic
from portbench.reference import canny as ref_canny
from portbench.reference import gpt as ref_gpt
from portbench.reference import vit as ref_vit
from portbench.reference import vq as ref_vq
from portbench.tests import tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module", params=["gpt3b_c2i384", "gptxl_t2i512"])
def cfg(request):
    return tiny.config(request.param)


def test_gpt_teacher_forced_logits(cfg):
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.models import gpt as gpt_model

    g = cfg["gpt"]
    w = program.make_weights(cfg, SEED, "cpu", parts=("gpt",))["gpt"]
    port = convert_ref.gpt_from_state_dict(w, program.gpt_config(cfg), torch.float32, "cpu")
    b = 3
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, g["vocab_size"], (b, g["block_size"]), generator=gen)
    feats = torch.randn(b, g["block_size"], g["adapter_dim"], generator=gen)
    kw, key_valid = {}, None
    if g["model_type"] == "c2i":
        labels = torch.tensor([0, 3, g["num_classes"]])
        prefix_port = gpt_model.embed_prefix_c2i(port, labels)
        kw["labels"] = labels
    else:
        cap = torch.randn(b, g["cls_token_num"], g["caption_dim"], generator=gen)
        mask = torch.as_tensor(traffic.caption_mask([2, 8, 5], g["cls_token_num"]))
        prefix_port = gpt_model.embed_prefix_t2i(port, cap)[:, : g["cls_token_num"]]
        key_valid = torch.cat([mask, torch.ones(b, g["block_size"] - 1, dtype=torch.bool)], 1)
        kw.update(caption=cap, caption_mask=mask)
    with torch.no_grad():
        cond = gpt_model.control_tokens(port, program.gpt_config(cfg), feats)
        want, _ = gpt_model.forward_train(port, program.gpt_config(cfg), prefix_port,
                                          tokens[:, :-1], cond_tokens=cond, key_valid=key_valid,
                                          attn_impl="einsum")
        prefix = ref_gpt.prefix_embedding(w, g, labels=kw.get("labels"), caption=kw.get("caption"))
        fused = ref_gpt.fusion(w, g, ref_gpt.control_tokens(w, g, feats))
        got = ref_gpt.forward(w, g, prefix, tokens[:, :-1], fused, kw.get("caption_mask"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_adapter(cfg):
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.models import vit as vit_model

    w = program.make_weights(cfg, SEED, "cpu", parts=("adapter",))["adapter"]
    port = convert_ref.vit_from_hf_state_dict(w, program.adapter_config(cfg), device="cpu")
    x = torch.randn(2, 56, 42, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = vit_model.vit_forward(port, program.adapter_config(cfg), x)
        got = ref_vit.forward(w, cfg["adapter"], x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_condition_input_matches_the_port():
    from controlar_tpu_torch.ops.resize import to_patch14
    from controlar_tpu_torch.pipeline import normalize_condition

    edges = (torch.rand(2, 384, 384, generator=torch.Generator().manual_seed(3)) > 0.7)
    edges = edges.to(torch.uint8) * 255
    want = to_patch14(normalize_condition(edges[..., None].expand(2, 384, 384, 3)), "canny")
    torch.testing.assert_close(ref_vit.condition_input(edges), want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["blocky", "noise"])
def test_canny_bit_for_bit(kind):
    from controlar_tpu_torch.ops.canny import canny

    if kind == "blocky":
        img = torch.as_tensor(traffic.condition_images(3, 96, SEED, "canny"))
    else:
        img = torch.randint(0, 256, (3, 64, 80, 3), generator=torch.Generator().manual_seed(4),
                            dtype=torch.uint8)
    want = canny(img, 100, 200)
    got = ref_canny.canny(img, 100, 200, 64)
    assert torch.equal(got, want)
    assert 0 < int((got > 0).sum()) < got.numel()


def test_tokenizer_decode(cfg):
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.models import vq as vq_model

    w = program.make_weights(cfg, SEED, "cpu", parts=("vq",))["vq"]
    port = convert_ref.vq_from_state_dict(w, program.vq_config(cfg), device="cpu")
    codes = torch.randint(0, cfg["vq"]["codebook_size"], (2, 4, 4),
                          generator=torch.Generator().manual_seed(5))
    want = vq_model.decode_code(port, program.vq_config(cfg), codes)
    got = ref_vq.decode_codes(w, cfg["vq"], codes)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dropout_masks_are_the_programs():
    """The reference's keyed draws are the program's, bit for bit, also
    for a block of the batch's rows."""
    from controlar_tpu_torch.models import gpt as gpt_model
    from controlar_tpu_torch.train.step import drop_ids
    from portbench.reference.train import Dropout, keyed_generator

    x = torch.randn(6, 5, 8, generator=torch.Generator().manual_seed(2))
    rows = torch.tensor([1, 4, 5])
    for key in [(SEED + 1234, 0, 1, 0), (SEED + 1234, 2, 1, 1, 3, 2)]:
        want = gpt_model._dropout(key, 0.3, x)
        got = Dropout(key[0], key[1], 0.3, 6, rows)(key[3:], x[rows])
        assert torch.equal(got, want[rows])
    c = tiny.config("gptxl_t2i512")
    gcfg = program.gpt_config(dict(c, train=dict(c["train"], class_dropout=0.5)))
    want = drop_ids(gcfg, 16, (SEED, 1, 0), "cpu")
    got = torch.rand(16, generator=keyed_generator((SEED, 1, 0), "cpu")) < 0.5
    assert torch.equal(got, want) and want.any() and not want.all()


def test_training_dropout_follows_the_program(cfg):
    """The program's training forward with CFG, token, attention and FFN
    dropout at high rates, and the reference's in blocks of rows with the
    replayed masks: the same loss."""
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.models import gpt as gpt_model
    from controlar_tpu_torch.train.step import drop_ids, prefix_embedding
    from portbench.reference.train import Dropout, keyed_generator

    c = dict(cfg, train={"dropout": 0.3, "class_dropout": 0.5})
    g, gcfg = c["gpt"], program.gpt_config(c)
    w = program.make_weights(c, SEED, "cpu", parts=("gpt",))["gpt"]
    port = convert_ref.gpt_from_state_dict(dict(w), gcfg, torch.float32, "cpu")
    b, s_key, k = 8, SEED + 1234, 2
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, g["vocab_size"], (b, g["block_size"]), generator=gen)
    feats = torch.randn(b, g["block_size"], g["adapter_dim"], generator=gen)
    batch, kw, key_valid = {}, {}, None
    if g["model_type"] == "c2i":
        batch["labels"] = kw["labels"] = torch.randint(0, g["num_classes"], (b,), generator=gen)
    else:
        cap = torch.randn(b, g["cls_token_num"], g["caption_dim"], generator=gen)
        mask = torch.as_tensor(traffic.caption_mask([2, 8, 5, 3, 8, 1, 6, 4], g["cls_token_num"]))
        batch.update(caption_emb=cap, emb_mask=mask)
        key_valid = torch.cat([mask, torch.ones(b, g["block_size"] - 1, dtype=torch.bool)], 1)
        kw.update(caption=cap, caption_mask=mask)
    with torch.no_grad():
        dropped = drop_ids(gcfg, b, (s_key, k, 0), "cpu")
        cond = gpt_model.control_tokens(port, gcfg, feats, dropped)
        prefix = prefix_embedding(port, gcfg, batch, dropped, torch.float32)
        _, want = gpt_model.forward_train(port, gcfg, prefix, tokens[:, :-1], cond_tokens=cond,
                                          key_valid=key_valid, targets=tokens, rng=(s_key, k, 1),
                                          deterministic=False, remat_policy="none",
                                          attn_impl="einsum")
        ref_dropped = torch.rand(b, generator=keyed_generator((s_key, k, 0), "cpu")) < 0.5
        assert ref_dropped.any() and not ref_dropped.all()
        total = 0.0
        for blk in torch.arange(b).split(3):
            one = {n: v[blk] for n, v in kw.items()}
            total += ref_gpt.train_loss(w, g, tokens[blk], feats[blk], remat=False,
                                        dropped=ref_dropped[blk],
                                        drop=Dropout(s_key, k, 0.3, b, blk), **one)
        plain = ref_gpt.train_loss(w, g, tokens, feats, remat=False, **kw)
    n = b * g["block_size"]
    torch.testing.assert_close(total / n, want, rtol=1e-5, atol=1e-6)
    assert abs(float(plain) / n - float(want)) > 1e-3  # the dropout does move the loss


def test_released_layout_keys_load_whole(cfg):
    """Every key the loaders need is among the benchmark's, and every key it
    makes is one the reference reads or the loader's layout holds."""
    from controlar_tpu_torch import convert_ref

    w = program.make_weights(cfg, SEED, "cpu")
    gpt = convert_ref.gpt_from_state_dict(w["gpt"], program.gpt_config(cfg), device="cpu")
    assert set(convert_ref.gpt_reference_state_dict(gpt)) == set(w["gpt"])
    vq = convert_ref.vq_from_state_dict(w["vq"], program.vq_config(cfg), device="cpu")
    assert set(convert_ref.vq_reference_state_dict(vq)) == set(w["vq"])
    vit = convert_ref.vit_from_hf_state_dict(w["adapter"], program.adapter_config(cfg),
                                             device="cpu")
    assert set(convert_ref.vit_hf_state_dict(vit, program.adapter_config(cfg))) == set(w["adapter"])


def test_train_step_matches_the_port_in_fp32():
    """The reference's AdamW step against the port's optimizer on the same
    gradients: clip, moments, bias correction, decoupled decay by key."""
    from controlar_tpu_torch.train.optimizer import AdamW

    cfg = tiny.config("gptxl_t2i512")
    o = cfg["train"]
    gen = torch.Generator().manual_seed(6)
    shapes = {"gpt.layers.0.attention.wqkv.weight": (6, 4), "gpt.norm.weight": (4,),
              "adapter.encoder.layer.0.norm1.bias": (4,), "adapter.embeddings.cls_token": (1, 1, 4)}
    port_names = {"gpt.layers.0.attention.wqkv.weight": "gpt.layers.0.wqkv.weight",
                  "gpt.norm.weight": "gpt.norm",
                  "adapter.encoder.layer.0.norm1.bias": "adapter.layers.0.norm1.bias",
                  "adapter.embeddings.cls_token": "adapter.cls_token"}
    from portbench.reference.train import Step

    step = Step.__new__(Step)
    step.opt = o
    step.params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    step.m = {k: torch.zeros_like(v) for k, v in step.params.items()}
    step.v = {k: torch.zeros_like(v) for k, v in step.params.items()}
    step.t = 0
    tx = AdamW(lr=o["lr"], weight_decay=o["weight_decay"], beta1=o["beta1"], beta2=o["beta2"],
               eps=o["eps"], max_grad_norm=o["max_grad_norm"])
    pp = {port_names[k]: v.clone().reshape(-1) if k.endswith("cls_token") else v.clone()
          for k, v in step.params.items()}
    state = tx.init(pp)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        step.apply(grads)
        state, _ = tx.step(pp, {port_names[k]: g.reshape(pp[port_names[k]].shape)
                                for k, g in grads.items()}, state)
    for k, v in step.params.items():
        torch.testing.assert_close(v.reshape(-1), pp[port_names[k]].reshape(-1), rtol=1e-5,
                                   atol=1e-7)
