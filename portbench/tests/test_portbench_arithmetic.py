"""The yardstick's arithmetic against hand-worked cases."""
import math
import re
from types import SimpleNamespace

import pytest

from portbench.harness import roofline as rl
from portbench.harness import stats
from portbench.tests import tiny


def test_bound_picks_the_larger_time():
    t, kind = rl.bound(3.35e12, 1.0, 1e12)
    assert t == pytest.approx(1.0) and kind == "bytes"
    t, kind = rl.bound(1.0, 2e12, 1e12)
    assert t == pytest.approx(2.0) and kind == "operations"


def test_decode_bound_by_hand():
    # two rows at positions 2 and 4 (3 and 5 live rows), 2 heads of 4:
    # q + out 2 * 2 * 2 * 4 * 2 = 64 B, K and V 8 * 2 * 2 * 4 * 2 = 256 B,
    # bias 8 * 4 = 32 B; 4 * 8 * 2 * 4 = 256 flops
    assert rl.decode_bound([3, 5], 2, 4, False) == pytest.approx(max(320 / 3.35e12, 256 / 67e12))
    assert rl.decode_bound([3, 5], 2, 4, True) == pytest.approx(352 / 3.35e12)


def test_train_bound_by_hand():
    # b 1, t 2, h 1, d 2: 3 causal pairs; bf16 tensors 8 B, f32 rows 8 B
    assert rl.train_bound("fwd", 1, 2, 1, 2, False) == pytest.approx(
        max((4 * 8 + 8) / 3.35e12, 2 * 2 * 2 * 3 / 989e12))
    assert rl.train_bound("dkv", 1, 2, 1, 2, True) == pytest.approx(
        max((6 * 8 + 2 * 8 + 8) / 3.35e12, 2 * 4 * 2 * 3 / 989e12))


def test_decode_flops_by_hand():
    g = {"dim": 4, "ffn_dim": 8, "n_layer": 2, "vocab_size": 10, "cls_token_num": 2}
    layers = 2 * (3 * 16 + 16 + 3 * 32)  # 320
    head = 40
    # positions 0, 1, 2 of one row: the head at positions >= 1
    want = (2 * layers + 4 * 2 * 4 * 1) + (2 * layers + 4 * 2 * 4 * 2 + 2 * head) + \
        (2 * layers + 4 * 2 * 4 * 3 + 2 * head)
    assert rl.decode_flops(g, 3, range(3)) == pytest.approx(3 * want)


def test_palm_flops_counts_the_ports_matmul_parameters():
    """The same N as the port's own count (every tensor of a layer, two or
    more dimensions elsewhere), built from a tiny configuration."""
    import torch

    from controlar_tpu_torch.models import gpt as gpt_model
    from controlar_tpu_torch.models import vit as vit_model
    from portbench.harness import program

    cfg = tiny.config("gptxl_t2i512")
    g, a = cfg["gpt"], cfg["adapter"]
    per_layer = re.compile(r"(^|\.)layers\.\d+\.")

    def n(module):
        return sum(p.numel() for name, p in module.named_parameters()
                   if p.dim() + bool(per_layer.search(name)) >= 2)

    with torch.device("meta"):
        gpt = gpt_model.GPT(program.gpt_config(cfg))
        vit = vit_model.ViT(program.adapter_config(cfg))
    t_gpt = g["cls_token_num"] + g["block_size"] - 1
    t_ad = (cfg["image_px"] // 16 * 14 // a["patch_size"]) ** 2 + 1
    want = 3 * (6 * n(gpt) * t_gpt + 12 * g["n_layer"] * t_gpt ** 2 * g["dim"]
                + 6 * n(vit) * t_ad + 12 * a["n_layer"] * t_ad ** 2 * a["hidden_size"])
    assert rl.palm_flops(g, a, cfg["image_px"], 3) == want


def ctx(window=None, slice_=None, cfg=None, traffic=None):
    return SimpleNamespace(window=window or {}, slice=slice_, cfg=cfg or {}, traffic=traffic or {},
                           setup_s=1.0, peak_bytes=0)


def test_train_rate_counts_every_step_of_the_window():
    from portbench.tests.test_portbench_imports import load_reader

    read = load_reader("train_images_per_s")
    assert read(ctx({"kind": "train", "seconds": 50.0, "steps": 34, "batch": 32})) == \
        pytest.approx(34 * 32 / 50.0)
    assert read(ctx({"kind": "gen"})) is None


def test_token_counted_rate():
    from portbench.tests.test_portbench_imports import load_reader

    read = load_reader("gen_images_per_s")
    # two whole calls of 32 images and one cut after 100 of 576 tokens a row
    w = {"kind": "gen", "seconds": 20.0, "tokens_per_image": 576,
         "tokens": 32 * (576 + 576 + 100)}
    assert read(ctx(w)) == pytest.approx(32 * (2 + 100 / 576) / 20.0)
    assert read(ctx({"kind": "train"})) is None


def test_mfu_and_idle():
    cfg = tiny.config("gpt3b_c2i384")
    g = cfg["gpt"]
    w = {"kind": "gen", "seconds": 2.0, "batch": 2, "calls": [{"tokens_per_row": 16}]}
    want = 100 * rl.decode_flops(g, 4, range(g["cls_token_num"] + 15)) / 2.0 / 989e12
    assert stats.mfu(ctx(w, cfg=cfg), "gen") == pytest.approx(want)
    s = {"kind": "gen", "busy_s": 0.25, "wall_s": 1.0}
    assert stats.idle_share(ctx(slice_=s), "gen") == pytest.approx(75.0)
    assert stats.idle_share(ctx(slice_=s), "train") is None


def test_roofline_share_from_the_slice():
    cfg = tiny.config("gpt3b_c2i384")
    g = cfg["gpt"]
    live = [[5] * 4, [6] * 4]
    least = sum(g["n_layer"] * rl.decode_bound(r, g["n_head"], g["head_dim"], False) for r in live)
    s = {"kind": "gen", "kernel_s": {"void flash_decode_kernel<64>(...)": least * 4},
         "kernel_count": {"void flash_decode_kernel<64>(...)": 2 * g["n_layer"]},
         "live_rows": [5, 6], "rows": 4, "bias": False}
    assert stats.decode_roofline(ctx(slice_=s, cfg=cfg), "gen") == pytest.approx(25.0)
    s["kernel_count"] = {"void flash_decode_kernel<64>(...)": 1}  # launches not as planned
    assert stats.decode_roofline(ctx(slice_=s, cfg=cfg), "gen") is None


def test_trace_summary_idle_gaps_named_by_the_host():
    from portbench.harness.trace import summarize

    events = [
        {"cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"cat": "kernel", "name": "k1", "ts": 40, "dur": 10},
        {"cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "sampling", "ts": 16, "dur": 20},
    ]
    s = summarize(events, 1e-4)
    assert s["busy_s"] == pytest.approx(25e-6)  # [0, 15] and [40, 50]
    assert s["kernel_count"] == {"k1": 2, "k2": 1}
    assert s["idle_gaps"] == [["sampling", pytest.approx(25e-6)]]
    assert math.isclose(s["wall_s"], 1e-4)


def test_a_null_limit_is_printed_not_compared(capsys):
    from portbench.harness import check

    got = check.compared([("loss_gap", 5e-5), ("grad_gap", 0.01), ("update_gap", 0.02)],
                         {"loss_gap": None, "grad_gap": 0.018})
    assert got == [("grad_gap", 0.01, 0.018), ("update_gap", 0.02, 0.0)]
    assert "loss_gap 5e-05 (not compared)" in capsys.readouterr().err
    assert not check.verdict(got, 0)
