"""Loader/bindings for the native host runtime (native/runtime.cpp).

The shared library is compiled on first use with the local C++ toolchain
(``g++ -O3 -shared -fPIC``) into a per-source-hash cache path, then bound
via ctypes (this image has no pybind11; the C ABI + ctypes is the binding
layer).  Every caller must handle ``load() is None`` and fall back to the
pure-Python implementation — the native layer is an accelerator, not a
dependency.

Contents (see native/runtime.cpp):
  * ga_fasta_parse / ga_fasta_free — streaming FASTA reader
  * ga_tokenize — char->token id buffer fill
  * ga_traceback_walk / ga_render_ops — O(m+n) move-code walk
  * ga_bucket_lengths — batch bucketizer
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parents[2] / "native" / "runtime.cpp"
_CACHE_DIR = Path(
    os.environ.get(
        "GLOBALIGN_NATIVE_CACHE",
        Path.home() / ".cache" / "globalign_jax" / "native",
    )
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


class _GaFasta(ctypes.Structure):
    _fields_ = [
        ("desc", ctypes.POINTER(ctypes.c_char)),
        ("desc_off", ctypes.POINTER(ctypes.c_int64)),
        ("seq", ctypes.POINTER(ctypes.c_char)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_records", ctypes.c_int64),
        ("err", ctypes.c_char * 256),
    ]


def _compile() -> Path | None:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _CACHE_DIR / f"runtime-{digest}.so"
    if so_path.exists():
        return so_path
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(".so.tmp")
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        str(tmp),
        str(_SRC),
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    os.replace(tmp, so_path)
    return so_path


def load() -> ctypes.CDLL | None:
    """The bound native library, or None if unavailable (use the fallback)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("GLOBALIGN_NO_NATIVE"):
            _load_failed = True
            return None
        so_path = _compile()
        if so_path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError:
            _load_failed = True
            return None

        lib.ga_fasta_parse.argtypes = [ctypes.c_char_p]
        lib.ga_fasta_parse.restype = ctypes.POINTER(_GaFasta)
        lib.ga_fasta_free.argtypes = [ctypes.POINTER(_GaFasta)]
        lib.ga_fasta_free.restype = None
        lib.ga_tokenize.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ga_tokenize.restype = ctypes.c_int64
        lib.ga_traceback_walk.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ga_traceback_walk.restype = ctypes.c_int64
        lib.ga_render_ops.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.ga_render_ops.restype = None
        lib.ga_bucket_lengths.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ga_bucket_lengths.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# High-level wrappers (None -> caller must use the Python fallback)
# ---------------------------------------------------------------------------


def fasta_records(path) -> list[tuple[str, str]] | None:
    """All (description, sequence) records, or None if native is unavailable.

    Raises the same error classes as the Python parser
    (utils/fasta.py, mirroring reference start.py:632,645) on bad input.
    """
    lib = load()
    if lib is None:
        return None
    p = lib.ga_fasta_parse(str(path).encode())
    if not p:
        return None
    try:
        c = p.contents
        err = bytes(c.err).split(b"\0", 1)[0].decode()
        if err:
            if "cannot open" in err:
                raise FileNotFoundError(f"{path}: {err}")
            raise RuntimeError(err)
        nrec = c.n_records
        desc_off = [c.desc_off[i] for i in range(nrec + 1)]
        seq_off = [c.seq_off[i] for i in range(nrec + 1)]
        desc_buf = ctypes.string_at(c.desc, desc_off[-1]).decode()
        seq_buf = ctypes.string_at(c.seq, seq_off[-1]).decode()
        return [
            (
                desc_buf[desc_off[i] : desc_off[i + 1]],
                seq_buf[seq_off[i] : seq_off[i + 1]],
            )
            for i in range(nrec)
        ]
    finally:
        lib.ga_fasta_free(p)


def traceback_walk(moves, seq_1: str, seq_2: str, start_level: int):
    """Native move-code walk; returns (seq_1_aligned, middle, seq_2_aligned)
    or None if native is unavailable.  ``moves`` is the row-major
    (m+1, n+1) uint8 array from the row fill."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    moves = np.ascontiguousarray(moves, dtype=np.uint8)
    m, n = len(seq_1), len(seq_2)
    assert moves.shape[0] >= m + 1 and moves.shape[1] >= n + 1
    ops = np.empty(m + n, dtype=np.uint8)
    k = int(lib.ga_traceback_walk(
        moves.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        moves.shape[1],
        m,
        n,
        start_level,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    out_1 = ctypes.create_string_buffer(k)
    mid = ctypes.create_string_buffer(k)
    out_2 = ctypes.create_string_buffer(k)
    lib.ga_render_ops(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        k,
        seq_1.encode(),
        seq_2.encode(),
        out_1,
        mid,
        out_2,
    )
    return (
        out_1.raw[:k].decode(),
        mid.raw[:k].decode(),
        out_2.raw[:k].decode(),
    )
