"""Named host spans for the torch profiler.

`with span("decode.step"): ...` opens a profiler range while a torch
profiler is recording (a `torch.profiler.profile` block, the Trainer's
`profile_dir` window, `trace_decode`, `trace_train`), so the span lands in
the profiler's trace, as a host event (`cpu_op`) named after the span, on
the clock of the device's kernels and copies. The range is the profiler's
fast record function: `torch.profiler.record_function`'s enter and exit are
operators of their own, dispatched and recorded, and cost more a span under
the profiler. It is looked up when a span is opened, so importing this
module needs nothing of the profiler. With no profiler recording `span`
costs one check and returns a shared no-op context. The profiler keeps the
spans and writes them with its trace; nothing is kept here.

The spans, `<layer>.<part>`, each with what reads it (`portbench`'s
per-layer metrics, and `python3 -m portbench.harness.spans <trace>`, which
tables every span of a saved trace):

  decode.step                      one decode step of `generate_tokens`:
                                   decode_launches.gen
  decode.sample                    the CFG mix and the sampler: sampler_ms.gen
  decode.fuse, decode.attn,        one layer of a decode step
  decode.ffn                       (`decode._decode_layers`): the table
  decode.logits                    the step's final norm and head: the table
  train.data                       `Trainer.put_batch`, pin and copy in: the
                                   table
  train.forward                    the compute copies through the loss:
                                   forward_ms.train
  train.condition, train.adapter   the control step's condition map and
                                   adapter, inside train.forward:
                                   condition_ms.train; the table
  train.backward                   the gradients (and their reduction over
                                   a mesh), remat's recompute included:
                                   backward_ms.train
  train.update                     frozen gradients zeroed, clip, AdamW, EMA:
                                   update_ms.train
"""
from __future__ import annotations

import contextlib

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` while a torch profiler records, else
    the shared no-op context."""
    if _recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
