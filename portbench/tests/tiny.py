"""A tiny copy of the benchmark for CPU tests: the manifest with the same
cells over configurations shrunk to a few layers and a 4 x 4 token grid, in
a temporary root that links back to the real `portbench/` files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

ADAPTER = {"name": "tiny", "hidden_size": 384, "n_layer": 1, "n_head": 6, "mlp_dim": 96,
           "patch_size": 14, "pos_grid": 37, "layer_norm_eps": 1e-6, "dtype": "float32"}
VQ = {"name": "tiny", "codebook_size": 256, "embed_dim": 8, "z_channels": 32, "ch": 32,
      "ch_mult": [1, 1, 1, 1, 2], "num_res_blocks": 1, "dtype": "float32"}


def gpt(model_type: str) -> dict:
    return {"size": "GPT-B", "dim": 64, "n_layer": 3, "n_head": 2, "head_dim": 32,
            "ffn_dim": 256, "vocab_size": 256, "num_classes": 10, "model_type": model_type,
            "cls_token_num": 1 if model_type == "c2i" else 8, "block_size": 16, "grid": [4, 4],
            "caption_dim": 32, "adapter_dim": 384, "n_fusion_points": 3, "norm_eps": 1e-5,
            "rope_base": 10000.0, "initializer_range": 0.02, "dtype": "float32"}


def config(name: str) -> dict:
    real = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    model_type = real["gpt"]["model_type"]
    out = dict(real, gpt=gpt(model_type), adapter=ADAPTER, vq=VQ, image_px=64)
    out["sampling"] = dict(real["sampling"], top_k=50)
    if "train" in real:
        out["train"] = dict(real["train"], remat="none")
    return out


TRAFFIC = {
    "gen_b32": {"batch": 2, "max_calls": 4, "warm_steps": 2, "check_rows": 2, "trace_steps": 2},
    "train_b32": {"batch": 2, "reference_rows": 1},
}


def make_root(tmp: Path, limits=None) -> Path:
    """tmp/BENCHMARK.json (the real one over tiny configurations) and
    tmp/portbench with tiny traffic, the real loops and readers, and
    generous limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "loops"):
        shutil.copytree(ROOT / "portbench" / sub, pb / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        (tmp / c["file"]).write_text(json.dumps(config(c["name"])))
    for w in bench["workloads"]:
        real = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        (pb / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(dict(real, **TRAFFIC.get(w["traffic"], {}))))
        lim = json.loads((ROOT / "portbench" / "limits" / f"{w['name']}.json").read_text())
        lim = {k: (limits or {}).get(k, 1e9) for k in lim}
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
