"""`BENCHMARK.json` and the files it names, found by name:

  portbench/configs/<config file>       a configuration's sizes (`file` in the manifest)
  portbench/traffic/<traffic>.json      a traffic mix's parameters, its "loop" among them
  portbench/loops/<loop>.py             the loop a traffic file names: its class Loop
  portbench/metrics/<metric>.py         the reader of one metric: read(ctx) -> value or None
  portbench/limits/<workload>.json      the limits of the numbers `correct` compares

A later change adds a cell, a configuration, a traffic mix, a loop or a
metric by adding such files and entries; nothing here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / BENCH_DIR.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                return dict(cfg, name=name)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return dict(json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text()),
                    name=name)

    def limits(self, workload: str) -> dict:
        path = self.bench_dir / "limits" / f"{workload}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The metrics a cell reports: kind "end_to_end" or "per_layer",
        those that list the cell or list no cells."""
        return [m for m in self.data[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        return self.load("metrics", metric).read

    def loop(self, name: str) -> type:
        return self.load("loops", name).Loop

    def load(self, kind: str, name: str):
        """The module `portbench/<kind>/<name>.py`."""
        path = self.bench_dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def problems(data: dict, root: Path = ROOT) -> List[str]:
    """What in a manifest breaks the benchmark's rules of names, units and
    references (empty when nothing does)."""
    out = []
    bench = root / BENCH_DIR.name
    metrics = data["end_to_end"] + data["per_layer"]
    names = [m["name"] for m in metrics]
    e2e = {m["name"]: m for m in data["end_to_end"]}
    cells = {w["name"]: w for w in data["workloads"]}
    configs = {c["name"]: c for c in data["configs"]}
    for group in (names, list(cells), list(configs)):
        if len(set(group)) != len(group):
            out.append(f"duplicate names in {group}")
    for m in metrics:
        if not NAME.match(m["name"]):
            out.append(f"metric name {m['name']!r}")
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
        if not (bench / "metrics" / f"{m['name']}.py").exists():
            out.append(f"no reader for {m['name']}")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"{m['name']} lists unknown cell {w}")
    for m in data["per_layer"]:
        moves = e2e.get(m.get("moves"))
        if moves is None:
            out.append(f"{m['name']} moves {m.get('moves')!r}, not an end-to-end metric")
            continue
        for w in m.get("workloads", list(cells)):
            if "workloads" in moves and w not in moves["workloads"]:
                out.append(f"{m['name']} in {w}, which does not report {moves['name']}")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            if m["unit"] != "%":
                out.append(f"{m['name']} is a roofline share in {m['unit']}")
    for c in configs.values():
        if not NAME.match(c["name"]) or not (root / c["file"]).exists():
            out.append(f"config {c['name']}: bad name or missing {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"reduced key {key!r}")
    for w in cells.values():
        if not NAME.match(w["name"]) or not NAME.match(w["traffic"]):
            out.append(f"cell {w['name']}: bad name")
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: unknown config {w['config']}")
        traffic = bench / "traffic" / f"{w['traffic']}.json"
        if not traffic.exists():
            out.append(f"cell {w['name']}: no traffic file {w['traffic']}.json")
        elif not (bench / "loops" / f"{json.loads(traffic.read_text())['loop']}.py").exists():
            out.append(f"cell {w['name']}: no loop module for {w['traffic']}")
        if not (bench / "limits" / f"{w['name']}.json").exists():
            out.append(f"cell {w['name']}: no limits file")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips {w['chips']}")
        reported = [m for m in metrics if "workloads" not in m or w["name"] in m["workloads"]]
        kinds = {("e2e" if m["name"] in e2e else "layer") for m in reported}
        if "setup_s" not in [m["name"] for m in reported] or kinds != {"e2e", "layer"} or \
                len([m for m in reported if m["name"] in e2e]) < 2:
            out.append(f"cell {w['name']}: needs setup_s, another end-to-end and a per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    if len(set(pairs)) != len(pairs):
        out.append("a (config, traffic) pair appears twice")
    return out
