"""carpack: one-file packed datasets with a native mmap reader (the port's
copy of the JAX package's `data/carpack.py`; the files are byte-identical).

Writer (Python) + reader. The reader uses the C++ library (`carpack.cpp`
beside this module, the port's copy of the JAX package's source), built
with g++ on first use into `controlar_tpu_torch/_build/` and cached by the
source's hash, for zero-copy mmap views. A failed build raises;
`force_python=True` selects the pure-Python reader, which has the same
semantics. Replaces the reference's trees of per-sample .npy/.png files
(dataset/t2i_control.py) for production input pipelines.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

MAGIC = b"CARPACK1"

_DTYPES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.int32): 1,
    np.dtype(np.int64): 2,
    np.dtype(np.float32): 3,
    np.dtype(np.float16): 4,
    np.dtype(bool): 6,
}
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}
RAW_BYTES = 7


class CarpackWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.offsets: List[int] = []
        self.f.write(MAGIC + struct.pack("<QQ", 0, 0))  # patched on close

    def write(self, record: Dict[str, np.ndarray | bytes]):
        self.offsets.append(self.f.tell())
        self.f.write(struct.pack("<I", len(record)))
        for name, value in record.items():
            nb = name.encode()
            assert len(nb) < 64
            self.f.write(struct.pack("<H", len(nb)) + nb)
            if isinstance(value, (bytes, bytearray)):
                self.f.write(struct.pack("<BB", RAW_BYTES, 1))
                self.f.write(struct.pack("<I", len(value)))
                self.f.write(struct.pack("<Q", len(value)))
                self.f.write(value)
            else:
                arr = np.ascontiguousarray(value)
                code = _DTYPES[arr.dtype]
                self.f.write(struct.pack("<BB", code, arr.ndim))
                for d in arr.shape:
                    self.f.write(struct.pack("<I", d))
                payload = arr.tobytes()
                self.f.write(struct.pack("<Q", len(payload)))
                self.f.write(payload)

    def close(self):
        index_off = self.f.tell()
        for off in self.offsets:
            self.f.write(struct.pack("<Q", off))
        self.f.seek(len(MAGIC))
        self.f.write(struct.pack("<QQ", len(self.offsets), index_off))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# Native reader
# ---------------------------------------------------------------------------

_SRC = Path(__file__).resolve().parent / "carpack.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_GXX = ["g++", "-O2", "-shared", "-fPIC"]
_LIB: Optional[ctypes.CDLL] = None


class _FieldView(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 64),
        ("dtype", ctypes.c_uint8),
        ("ndim", ctypes.c_uint8),
        ("dims", ctypes.c_uint32 * 8),
        ("data", ctypes.c_void_p),
        ("len", ctypes.c_uint64),
    ]


def _build_native() -> ctypes.CDLL:
    """The reader library, built on first use; raises if g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_GXX).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libcarpack-{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([*_GXX, "-o", str(tmp), str(_SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"carpack: g++ exited {res.returncode} building {_SRC}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.cp_open.restype = ctypes.c_void_p
    lib.cp_open.argtypes = [ctypes.c_char_p]
    lib.cp_count.restype = ctypes.c_long
    lib.cp_count.argtypes = [ctypes.c_void_p]
    lib.cp_record.restype = ctypes.c_int
    lib.cp_record.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(_FieldView), ctypes.c_int
    ]
    lib.cp_close.restype = None
    lib.cp_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class CarpackReader:
    """The native reader, or the Python one with force_python; `native`
    reports which."""

    MAX_FIELDS = 32

    def __init__(self, path: str, force_python: bool = False):
        self.path = path
        lib = None if force_python else _build_native()
        self._lib = lib
        if lib is not None:
            self._h = lib.cp_open(path.encode())
            if not self._h:
                raise OSError(f"carpack: failed to open {path}")
            self._n = lib.cp_count(self._h)
            self.native = True
        else:
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")
            raw = bytes(self._mm[:24])
            assert raw[:8] == MAGIC, "bad carpack file"
            self._n, index_off = struct.unpack("<QQ", raw[8:24])
            self._index = np.frombuffer(
                self._mm, np.uint64, count=self._n, offset=index_off
            )
            self.native = False

    def __len__(self):
        return int(self._n)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.native:
            views = (_FieldView * self.MAX_FIELDS)()
            n = self._lib.cp_record(self._h, i, views, self.MAX_FIELDS)
            if n < 0:
                raise IndexError(i)
            out = {}
            for k in range(n):
                v = views[k]
                name = v.name.decode()
                buf = ctypes.string_at(v.data, v.len)
                if v.dtype == RAW_BYTES:
                    out[name] = buf
                else:
                    dt = _DTYPES_INV[v.dtype]
                    shape = tuple(v.dims[d] for d in range(v.ndim))
                    out[name] = np.frombuffer(buf, dt).reshape(shape)
            return out
        return self._read_python(i)

    def _read_python(self, i: int) -> Dict[str, np.ndarray]:
        mm = self._mm
        cur = int(self._index[i])
        (n_fields,) = struct.unpack("<I", bytes(mm[cur: cur + 4]))
        cur += 4
        out = {}
        for _ in range(n_fields):
            (name_len,) = struct.unpack("<H", bytes(mm[cur: cur + 2]))
            cur += 2
            name = bytes(mm[cur: cur + name_len]).decode()
            cur += name_len
            dtype, ndim = int(mm[cur]), int(mm[cur + 1])
            cur += 2
            dims = struct.unpack(f"<{ndim}I", bytes(mm[cur: cur + 4 * ndim]))
            cur += 4 * ndim
            (payload,) = struct.unpack("<Q", bytes(mm[cur: cur + 8]))
            cur += 8
            raw = bytes(mm[cur: cur + payload])
            cur += payload
            if dtype == RAW_BYTES:
                out[name] = raw
            else:
                out[name] = np.frombuffer(raw, _DTYPES_INV[dtype]).reshape(dims)
        return out

    def close(self):
        if self.native and self._h:
            self._lib.cp_close(self._h)
            self._h = None


def pack_tree(tree_dir: str, out_path: str, condition_type: str = "canny"):
    """Pack a reference-style code tree into one carpack file."""
    from PIL import Image

    code_dir = os.path.join(tree_dir, "code")
    n = len(os.listdir(code_dir))
    with CarpackWriter(out_path) as w:
        for i in range(n):
            rec: Dict[str, np.ndarray | bytes] = {
                "tokens": np.load(os.path.join(code_dir, f"{i}.npy")).astype(np.int32),
            }
            cap_path = os.path.join(tree_dir, "caption_emb", f"{i}.npz")
            if os.path.exists(cap_path):
                cap = np.load(cap_path)
                rec["caption_emb"] = cap["caption_emb"].astype(np.float32)
            img_path = os.path.join(tree_dir, "image", f"{i}.png")
            if os.path.exists(img_path):
                rec["image"] = np.asarray(Image.open(img_path), np.uint8)
            ctrl_path = os.path.join(tree_dir, "control", f"{i}.png")
            if os.path.exists(ctrl_path):
                rec["control"] = np.asarray(Image.open(ctrl_path), np.uint8)
            w.write(rec)
    return n


# ---------------------------------------------------------------------------
# Training-pipeline integration
# ---------------------------------------------------------------------------

def pack_control_dataset(ds, out_path: str, limit: Optional[int] = None) -> int:
    """Pack ANY control dataset's items (T2IControlCodeDataset,
    C2ICodeDataset, ...) into one .car file, field-for-field.

    The packed items are byte-identical to the source dataset's, so training
    from the .car reproduces the tree run exactly (modulo loader shuffling,
    which is seed-driven and dataset-agnostic). Skips items with valid == 0
    (broken source files) — the packed file is fully dense.
    """
    n = len(ds) if limit is None else min(limit, len(ds))
    written = 0
    with CarpackWriter(out_path) as w:
        for i in range(n):
            item = ds[i]
            if float(item.get("valid", 1.0)) == 0.0:
                continue
            rec = {}
            for k, v in item.items():
                if isinstance(v, str):
                    rec[k] = v.encode()
                else:
                    rec[k] = np.ascontiguousarray(v)
            w.write(rec)
            written += 1
    return written


class CarpackControlDataset:
    """Training dataset over a packed .car file (drop-in for the tree
    datasets in the trainer/CLI: same item dicts, same make_batch).

    This is the production input path the reference lacks: one mmap'd file
    instead of millions of tiny .npy/.png reads (ref dataset/
    t2i_control.py:104-121); the native reader serves zero-copy field views.
    """

    def __init__(self, path: str, force_python: bool = False):
        self.reader = CarpackReader(path, force_python=force_python)
        self.native = self.reader.native

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.reader[i]
        out = {}
        for k, v in rec.items():
            out[k] = v.decode() if isinstance(v, bytes) else v
        if "valid" not in out:
            out["valid"] = np.float32(1.0)
        return out

    def make_batch(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        keys = items[0].keys()
        out = {}
        for k in keys:
            if k == "prompt":
                out[k] = [it[k] for it in items]
            else:
                out[k] = np.stack([np.asarray(it[k]) for it in items])
        return out
