"""What a metric reader is handed."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Context:
    cfg: dict                 # the configuration file
    traffic: dict             # the traffic file
    workload: str
    seed: int
    setup_s: float            # process start to the window's start
    peak_bytes: int           # torch.cuda.max_memory_allocated over set-up and window
    window: dict              # the loop's facts of the unprofiled window
    slice: Optional[dict]     # the profiled slice's summary and facts (--trace 1)
