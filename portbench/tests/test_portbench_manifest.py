"""The manifest: names and units, what each metric moves and where it is
read, every file found by name, and a cell, a metric, a loop and a
quantized configuration added by files and entries alone."""
import json
import re

import pytest

from portbench.harness import manifest
from portbench.tests import tiny

ROOT = tiny.ROOT
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_keeps_the_rules():
    assert manifest.problems(DATA, ROOT) == []


def test_keys_and_sizes():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["portbench"] and DATA["command"] == ["python3", "portbench/run.py"]
    assert 1 <= DATA["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    e2e = {m["name"] for m in DATA["end_to_end"]}
    assert e2e == {"gen_images_per_s", "train_images_per_s", "peak_mem_gib", "setup_s"}
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in DATA["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] == 1
    for c in DATA["configs"]:
        assert len(c["source"]) <= 200 and c["source"].startswith("https://")
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_roofline_and_mfu_names():
    for m in DATA["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^[a-z_]+_roofline(\.|$)", m["name"]) and m["unit"] == "%"
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert len(m["layer"]) <= 200
    movers = {m["moves"] for m in DATA["per_layer"] if m["name"].startswith("mfu.")}
    kernels = {m["moves"] for m in DATA["per_layer"] if "_roofline" in m["name"]}
    assert kernels <= movers


@pytest.mark.parametrize("bad", ["has space", "slash/name", "", "x" * 65, "café"])
def test_bad_names_are_refused(bad):
    data = json.loads(json.dumps(DATA))
    data["per_layer"][0]["name"] = bad
    assert manifest.problems(data, ROOT)


def test_bad_units_are_refused():
    data = json.loads(json.dumps(DATA))
    data["end_to_end"][0]["unit"] = "images per s"
    assert manifest.problems(data, ROOT)


def test_a_metric_moving_an_unreported_metric_is_refused():
    data = json.loads(json.dumps(DATA))
    m = next(m for m in data["per_layer"] if m["name"] == "mfu.train")
    m["workloads"] = ["gen.gpt3b_c2i384.b32"]
    assert manifest.problems(data, ROOT)


def test_a_stub_cell_and_metric_need_no_edit(tmp_path):
    """A new traffic file, limits file, metric reader and manifest entries,
    in a copy: the harness takes them as they are."""
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    (pb / "traffic" / "gen_b2.json").write_text(json.dumps(dict(
        json.loads((pb / "traffic" / "gen_b32.json").read_text()), batch=1)))
    (pb / "limits" / "gen.gpt3b_c2i384.b2.json").write_text(
        json.dumps({"logit_gap_mean": 1e9, "pixel_err": 1e9}))
    (pb / "metrics" / "calls_per_s.gen.py").write_text(
        "def read(ctx):\n    w = ctx.window\n"
        "    return len(w['calls']) / w['seconds'] if w.get('kind') == 'gen' else None\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "gen.gpt3b_c2i384.b2", "config": "gpt3b_c2i384",
                              "traffic": "gen_b2", "chips": 1, "why": "a stub"})
    for m in data["end_to_end"]:
        if m["name"] == "gen_images_per_s":
            m["workloads"].append("gen.gpt3b_c2i384.b2")
    data["per_layer"].append({"name": "calls_per_s.gen", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "decode loop (generate.py)",
                              "moves": "gen_images_per_s",
                              "workloads": ["gen.gpt3b_c2i384.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data, root) == []
    from portbench import run

    res = run.run(["--workload", "gen.gpt3b_c2i384.b2", "--seed", "7", "--seconds", "0.5",
                   "--trace", "1"], require_cuda=False, root=root)
    assert res["correct"] and "calls_per_s.gen" in res["metrics"]
    assert list(res)[-1] == "checked"


def test_a_stub_loop_needs_no_edit(tmp_path):
    """A new loop module, named by a new traffic file, found by its name."""
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    (pb / "loops" / "stub.py").write_text(
        "from portbench.harness.loops import Base\n\n\n"
        "class Loop(Base):\n"
        "    def setup(self, seconds):\n        self.n = self.traffic['n']\n\n"
        "    def window(self, seconds):\n"
        "        return {'kind': 'stub', 'seconds': seconds, 'n': self.n}\n\n"
        "    def free(self):\n        pass\n\n"
        "    def check(self, limits):\n"
        "        return [('stub_gap', 0.0, limits['stub_gap'])], self.n, 0\n")
    (pb / "traffic" / "stub_mix.json").write_text(json.dumps({"loop": "stub", "n": 3}))
    (pb / "limits" / "stub.gpt3b_c2i384.json").write_text(json.dumps({"stub_gap": 0.5}))
    (pb / "metrics" / "stub_rate.py").write_text(
        "def read(ctx):\n    w = ctx.window\n"
        "    return w['n'] / w['seconds'] if w.get('kind') == 'stub' else None\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "stub.gpt3b_c2i384", "config": "gpt3b_c2i384",
                              "traffic": "stub_mix", "chips": 1, "why": "a stub"})
    data["end_to_end"].append({"name": "stub_rate", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["stub.gpt3b_c2i384"]})
    data["per_layer"].append({"name": "stub_rate.layer", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "stub", "moves": "stub_rate",
                              "workloads": ["stub.gpt3b_c2i384"]})
    (pb / "metrics" / "stub_rate.layer.py").write_text((pb / "metrics" / "stub_rate.py").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data, root) == []
    from portbench import run

    res = run.run(["--workload", "stub.gpt3b_c2i384", "--seed", "5", "--seconds", "2"],
                  require_cuda=False, root=root)
    assert res["correct"] and res["attempted"] == 3
    assert res["metrics"]["stub_rate"]["value"] == pytest.approx(1.5)
    (pb / "traffic" / "stub_mix.json").write_text(json.dumps({"loop": "absent", "n": 3}))
    assert manifest.problems(data, root) == ["cell stub.gpt3b_c2i384: no loop module for stub_mix"]


def test_a_quantized_configuration_needs_no_edit(tmp_path):
    """A configuration whose "quant" group asks the program for W8A16
    weights and the int8 cache: a new file and entries, no code."""
    root = tiny.make_root(tmp_path)
    data = json.loads((root / "BENCHMARK.json").read_text())
    base = next(c for c in data["configs"] if c["name"] == "gpt3b_c2i384")
    cfg = json.loads((root / base["file"]).read_text())
    cfg["quant"] = {"weights": "int8", "cache": "int8"}
    (root / "portbench" / "configs" / "q8.json").write_text(json.dumps(cfg))
    data["configs"].append(dict(base, name="gpt3b_c2i384_w8kv8", file="portbench/configs/q8.json"))
    data["workloads"].append({"name": "gen.gpt3b_c2i384_w8kv8.b32", "config": "gpt3b_c2i384_w8kv8",
                              "traffic": "gen_b32", "chips": 1, "why": "a stub"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "gen.gpt3b_c2i384.b32" in m.get("workloads", []):
            m["workloads"].append("gen.gpt3b_c2i384_w8kv8.b32")
    (root / "portbench" / "limits" / "gen.gpt3b_c2i384_w8kv8.b32.json").write_text(
        json.dumps({"logit_gap_mean": 1e9, "pixel_err": 1e9}))
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data, root) == []
    from controlar_tpu_torch.quant import W8Linear
    from portbench import run
    from portbench.harness import program

    pipe = program.build_pipeline(manifest.Manifest(root).config("gpt3b_c2i384_w8kv8"), 3, "cpu")
    assert isinstance(pipe.gpt.layers[0].wqkv, W8Linear)
    assert program.generate_options(cfg) == {"cache_dtype": __import__("torch").int8}
    res = run.run(["--workload", "gen.gpt3b_c2i384_w8kv8.b32", "--seed", "3", "--seconds", "0.5"],
                  require_cuda=False, root=root)
    assert res["correct"] and res["metrics"]["gen_images_per_s"]["value"] > 0
