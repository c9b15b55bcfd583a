"""The C++ rosbag scanner (``bagparse.cpp``), bound with ctypes.

:func:`uslam_tpu_torch.io.rosbag.bag_to_sequence` with ``use_native=True``
runs its record scan and its fixed-layout streams (IMU, DVL pose, DVL
twist) through these two functions. The library is built with ``g++`` at
first use, never at import, into ``uslam_tpu_torch/_build/`` beside the
CUDA kernels, keyed by a hash of the source and the flags. A failed build
raises with the compiler's output: there is no fallback to the Python
reader, which the caller asks for with ``use_native=False``.

The JAX package's time join, id interning and IMU whiteners
(``ingest.cpp``, ``whitener.cpp``) have numpy counterparts in the port
(:mod:`uslam_tpu_torch.io.timesync`, :mod:`uslam_tpu_torch.graph.packing`,
:mod:`uslam_tpu_torch.graph.builder`) and are not built here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bagparse.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def load() -> ctypes.CDLL:
    """Build (if the source or flags changed) and load the bag scanner."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
        so = _BUILD_DIR / f"libuslam_bagparse_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True,
                )
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the native bag reader needs it") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.bag_scan_records.restype = ctypes.c_int64
        lib.bag_scan_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, i64p, i64p, i64p, i64p,
        ]
        lib.bag_decode_fixed.restype = ctypes.c_int64
        lib.bag_decode_fixed.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
            i64p, ctypes.c_int64, ctypes.c_int64, f64p,
        ]
        _LIB = lib
        return lib


def bag_scan_records(buf: np.ndarray):
    """Scan the rosbag records of a contiguous uint8 buffer.

    Returns (ops, conns, times, h_off, h_len, d_off, d_len), int64 arrays
    (times float64) with offsets relative to ``buf``. The scan stops at a
    record whose length fields overrun the buffer; the caller checks that
    the records cover it."""
    lib = load()
    buf = np.ascontiguousarray(buf, np.uint8)
    # A record takes at least 17 bytes (two length words and a minimal header).
    cap = max(len(buf) // 17, 16)
    ops, conns, h_off, h_len, d_off, d_len = (np.empty(cap, np.int64) for _ in range(6))
    times = np.empty(cap, np.float64)
    n = lib.bag_scan_records(buf, len(buf), cap, ops, conns, times, h_off, h_len, d_off, d_len)
    return tuple(a[:n] for a in (ops, conns, times, h_off, h_len, d_off, d_len))


def bag_decode_fixed(buf: np.ndarray, offs, lens, prog, out_w: int):
    """Decode fixed-layout messages at ``offs``/``lens`` of ``buf`` with the
    (opcode, arg) program ``prog``. Returns (out (n, out_w) float64, the
    number of messages decoded before the first that overran its bytes)."""
    lib = load()
    buf = np.ascontiguousarray(buf, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    prog = np.ascontiguousarray(np.asarray(prog, np.int64).reshape(-1))
    out = np.zeros((len(offs), out_w), np.float64)
    n = lib.bag_decode_fixed(buf, len(buf), offs, lens, len(offs), prog, len(prog) // 2, out_w, out)
    return out, int(n)
