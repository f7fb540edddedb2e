"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`, where the hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is rebuilt. All missing libraries are compiled at
once, one nvcc process per source, on first use.
The build uses only the sources in this package; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> None:
    """Compile every source whose library is missing, in parallel."""
    todo = [(src, _lib_path(src)) for src in sources() if not _lib_path(src).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu."""
    lib = _loaded.get(name)
    if lib is None:
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(src)
        build_all()
        lib = ctypes.CDLL(str(_lib_path(src)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use) for csrc/<name>.cu."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
