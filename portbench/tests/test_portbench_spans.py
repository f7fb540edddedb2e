"""`harness/spans.py` and the readers of the program's spans, on synthetic
chrome-trace events: device operations matched to their launches by
correlation, launches on another thread, nested spans, spans cut by the
slice's end, unattributed operations, and each reader's None where it has
nothing to read."""
import gzip
import json

import pytest

from portbench.harness import manifest, spans
from portbench.harness.context import Context
from portbench.tests import tiny

MAIN, AUTOGRAD = 1, 2
END = 10_000.0  # the record window's end (us)

GEN_READERS = ("decode_launches.gen", "sampler_ms.gen")
TRAIN_READERS = ("condition_ms.train", "forward_ms.train", "backward_ms.train",
                 "update_ms.train")


def window(end=END):
    return [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0.0,
             "dur": end - 100.0, "pid": "Spans", "tid": "PyTorch Profiler"},
            {"ph": "i", "name": "Record Window End", "ts": end, "pid": "", "tid": ""}]


def span(name, ts, dur, tid=MAIN, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 4.0,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def op(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def train_events():
    """Two steps: data, forward (holding condition), backward (launches on
    the autograd thread), update; kernels run late on the device."""
    ev = window()
    for k, t in enumerate((0.0, 4000.0)):
        c = 100 * (k + 1)
        ev += [span(n, t + a, d) for n, a, d in (
            ("train.data", 10, 40), ("train.forward", 100, 900), ("train.condition", 150, 100),
            ("train.backward", 1100, 1500), ("train.update", 2700, 600))]
        ev += [launch(c + 1, t + 20), op(c + 1, t + 30, 5, cat="gpu_memcpy"),
               launch(c + 2, t + 160), op(c + 2, t + 400, 30),      # condition
               launch(c + 3, t + 600), op(c + 3, t + 700, 200),     # forward
               launch(c + 4, t + 1200, tid=AUTOGRAD), op(c + 4, t + 1300, 500),
               launch(c + 5, t + 1300, tid=AUTOGRAD, cat="cuda_driver"),
               op(c + 5, t + 1900, 300),                              # backward
               launch(c + 6, t + 2800), op(c + 6, t + 3400, 100, cat="gpu_memset")]
    return ev


def test_attribution_by_correlation_on_any_thread():
    s = spans.Spans(train_events())
    assert s.count("train.forward") == 2
    assert s.device_ms("train.data") == pytest.approx(2 * 0.005)
    assert s.device_ms("train.condition") == pytest.approx(2 * 0.030)
    assert s.device_ms("train.forward") == pytest.approx(2 * 0.230)  # condition in it
    assert s.device_ms("train.backward") == pytest.approx(2 * 0.800)  # the autograd thread's
    assert s.device_ms("train.update") == pytest.approx(2 * 0.100)
    assert s.launches("train.backward") == 4
    assert s.unattributed() == (0, 0.0)
    assert s.total_device_ms() == pytest.approx(2 * 1.135)


def test_only_the_programs_span_category_counts():
    """A `user_annotation` (a `record_function` range) with a program span's
    name is not one of the program's spans."""
    ev = window() + [span("decode.step", 0, 100, cat="user_annotation"),
                     span("decode.step", 200, 100), launch(1, 10), op(1, 20, 5)]
    s = spans.Spans(ev)
    assert s.count("decode.step") == 1 and s.launches("decode.step") == 0
    assert s.unattributed() == (1, pytest.approx(0.005))


def test_the_device_time_does_not_decide():
    """A kernel launched in one span runs on the device during another's
    host interval: the launch decides."""
    ev = window() + [span("decode.step", 0, 100), span("decode.sample", 200, 50),
                     launch(1, 10), op(1, 210, 20), launch(2, 210), op(2, 20, 5)]
    s = spans.Spans(ev)
    assert s.device_ms("decode.step") == pytest.approx(0.020)
    assert s.device_ms("decode.sample") == pytest.approx(0.005)


def test_nested_spans_count_once_each():
    ev = window() + [span("decode.step", 0, 100), span("decode.attn", 10, 20),
                     span("decode.sample", 60, 30), span("decode.sample", 500, 30),
                     launch(1, 15), op(1, 50, 7), launch(2, 70), op(2, 90, 3)]
    s = spans.Spans(ev)
    assert s.launches("decode.step") == 2 and s.launches("decode.attn") == 1
    assert s.device_ms("decode.step") == pytest.approx(0.010)
    assert s.host_ms("decode.sample") == pytest.approx(0.060)
    assert s.host_ms("decode.sample", within="decode.step") == pytest.approx(0.030)


def test_spans_cut_by_the_slice_end_are_ignored():
    ev = window() + [span("decode.step", 100, 200), span("decode.step", 9000, END - 9000),
                     launch(1, 150), op(1, 160, 10), launch(2, 9100), op(2, 9200, 40)]
    s = spans.Spans(ev)
    assert s.count("decode.step") == 1 and s.launches("decode.step") == 1
    assert s.unattributed() == (1, pytest.approx(0.040))


def test_without_a_window_end_the_profilers_span_bounds_the_slice():
    ev = [e for e in window() if e["ph"] != "i"]
    ev += [span("train.update", 100, 200), span("train.update", 9500, 1000)]
    assert spans.Spans(ev).count("train.update") == 1


def test_unattributed_operations():
    ev = window() + [span("decode.step", 100, 100), span("decode_step", 0, 5000),
                     span("aten::mm", 280, 40),
                     launch(1, 150), op(1, 150, 10),
                     launch(2, 300), op(2, 310, 20),     # in the benchmark's own span only
                     op(3, 400, 30, name="no launch")]  # its launch is not in the trace
    s = spans.Spans(ev)
    assert s.count("decode_step") == s.count("aten::mm") == 0  # not program spans
    n, ms = s.unattributed()
    assert n == 2 and ms == pytest.approx(0.050)
    table = s.table()
    assert table["unattributed"] == {"ops": 2, "device_ms": pytest.approx(0.050)}
    assert table["spans"]["decode.step"]["launches"] == 1
    assert table["spans"]["decode.step"]["top"] == [("k", pytest.approx(0.010))]


def ctx(kind=None, busy_s=0.5, workload="cell"):
    sliced = None if kind is None else {"kind": kind, "busy_s": busy_s, "wall_s": 1.0}
    return Context(cfg={}, traffic={}, workload=workload, seed=0, setup_s=0.0, peak_bytes=0,
                   window={}, slice=sliced)


def readers():
    m = manifest.Manifest(tiny.ROOT)
    return {n: m.reader(n) for n in GEN_READERS + TRAIN_READERS}


@pytest.fixture
def saved(tmp_path, monkeypatch):
    """The traces the readers find: a gen cell's and a train cell's."""
    gen = window()
    for k in range(4):
        t = 1000.0 * k
        gen += [span("decode.step", t, 800), span("decode.attn", t + 10, 300),
                span("decode.sample", t + 600, 100)]
        gen += [launch(10 * k + j, t + 20 + 10 * j) for j in range(3)]
        gen += [op(10 * k + j, t + 100 * j, 10) for j in range(3)]
    paths = {}
    for name, events in (("gen", gen), ("train", train_events())):
        paths[name] = tmp_path / f"{name}.json.gz"
        with gzip.open(paths[name], "wt") as f:
            json.dump({"traceEvents": events}, f)
    monkeypatch.setattr(spans, "trace_path", lambda workload: paths[workload])
    return paths


def test_readers_read_the_saved_slice(saved):
    r = readers()
    assert r["decode_launches.gen"](ctx("gen", workload="gen")) == 3
    assert r["sampler_ms.gen"](ctx("gen", workload="gen")) == pytest.approx(0.1)
    train = ctx("train", workload="train")
    assert r["condition_ms.train"](train) == pytest.approx(0.030)
    assert r["forward_ms.train"](train) == pytest.approx(0.230)
    assert r["backward_ms.train"](train) == pytest.approx(0.800)
    assert r["update_ms.train"](train) == pytest.approx(0.100)


@pytest.mark.parametrize("name", GEN_READERS + TRAIN_READERS)
def test_readers_return_none_with_nothing_to_read(name, saved):
    read = readers()[name]
    kind = name.rsplit(".", 1)[1]
    other = {"gen": "train", "train": "gen"}[kind]
    assert read(ctx(None)) is None                                 # untraced
    assert read(ctx(other, workload=other)) is None                # the other kind
    assert read(ctx(kind, busy_s=0.0, workload=kind)) is None      # a CPU run
    assert read(ctx(kind, workload=other)) is None                 # no such span there


def test_a_run_parses_its_trace_once_and_main_prints_the_table(saved, capsys):
    train = ctx("train", workload="train")
    first = spans.for_slice(train, "train")
    assert spans.for_slice(train, "train") is first
    assert first is not spans.for_slice(ctx("train", workload="train"), "train")
    assert spans.main([str(saved["train"])]) == 0
    table = json.loads(capsys.readouterr().out)
    assert table["spans"]["train.backward"]["count"] == 2
    assert table["unattributed"]["ops"] == 0
