"""The run's surroundings: the build and kernel caches inside the checkout,
the card check, the device record, and the check that no JAX module was
loaded."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

# top-level module names that may never be loaded by a run (the JAX package
# among them: `controlar_tpu_torch` begins with its name, so whole names are
# compared)
FORBIDDEN = ("jax", "jaxlib", "flax", "controlar_tpu")
CACHE_DIR = ".portbench_cache"


def prepare(root: Path) -> None:
    """Fixed cache directories inside the checkout, for every build or
    kernel cache a library may keep (the port's own kernels build into
    `controlar_tpu_torch/_build/`, also inside the checkout); libraries that
    could load JAX are kept from doing so."""
    cache = Path(root) / CACHE_DIR
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cards_or_exit(chips: int) -> None:
    """Exit with 3, printing no result, unless `chips` CUDA devices are there."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or '' if absent."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""
