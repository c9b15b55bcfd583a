"""The JAX package's C++ host runtime, bound with ctypes: the rosbag
scanner (``bagparse.cpp``), the time join, id interning and IMU interval
packing (``ingest.cpp``) and the IMU whiteners (``whitener.cpp``), each a
copy of the JAX package's source.

:func:`uslam_tpu_torch.io.rosbag.bag_to_sequence` with ``use_native=True``
runs its record scan and its fixed-layout streams (IMU, DVL pose, DVL
twist) through :func:`bag_scan_records` and :func:`bag_decode_fixed`. The
main path's time join, packing and whiteners stay numpy
(:mod:`uslam_tpu_torch.io.timesync`, :mod:`uslam_tpu_torch.graph.packing`,
:func:`uslam_tpu_torch.graph.builder.compute_imu_whiteners`); the other
functions here compute the same things natively.

Each library is built with ``g++`` at first use, never at import, into
``uslam_tpu_torch/_build/`` beside the CUDA kernels, keyed by a hash of
the source and the flags. A failed build raises with the compiler's
output: no function here falls back to Python or returns None where the
JAX package's does. :func:`available`, :func:`bag_available` and
:func:`whitener_available` say whether a library builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent / "_build"
_SRC = _SRC_DIR / "bagparse.cpp"
_INGEST_SRC = _SRC_DIR / "ingest.cpp"
_WHITENER_SRC = _SRC_DIR / "whitener.cpp"
# The JAX package's flags for each library.
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
WHITENER_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = _INGEST_LIB = _WHITENER_LIB = None

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I64, _F64 = ctypes.c_int64, ctypes.c_double


def _build(src: Path, flags: tuple) -> ctypes.CDLL:
    """Build ``src`` (if it or the flags changed since the last build) and
    load it. A failed build raises with the compiler's output."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    so = _BUILD_DIR / f"libuslam_{src.stem}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                ["g++", *flags, str(src), "-o", str(tmp)], capture_output=True, text=True,
            )
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the native {src.stem} library needs it") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def load() -> ctypes.CDLL:
    """Build (if the source or flags changed) and load the bag scanner."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _build(_SRC, CXX_FLAGS)
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.bag_scan_records.restype = _I64
            lib.bag_scan_records.argtypes = [
                u8p, _I64, _I64, _I64P, _I64P, _F64P, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.bag_decode_fixed.restype = _I64
            lib.bag_decode_fixed.argtypes = [
                u8p, _I64, _I64P, _I64P, _I64, _I64P, _I64, _I64, _F64P,
            ]
            _LIB = lib
        return _LIB


def _ingest() -> ctypes.CDLL:
    """Build (if needed) and load the time join, interning and packing."""
    global _INGEST_LIB
    with _LOCK:
        if _INGEST_LIB is None:
            lib = _build(_INGEST_SRC, CXX_FLAGS)
            lib.approx_time_join2.restype = _I64
            lib.approx_time_join2.argtypes = [
                _F64P, _I64, _F64P, _I64, _F64P, _I64, _F64, _I64P, _I64P, _I64P,
            ]
            lib.intern_ids.restype = _I64
            lib.intern_ids.argtypes = [_I64P, _I64, _I64P]
            lib.pack_imu_intervals.restype = None
            lib.pack_imu_intervals.argtypes = [
                _F64P, _I64, _I64P, _I64P, _I64, _I64, _F64, _F64P, _F64P,
            ]
            _INGEST_LIB = lib
        return _INGEST_LIB


def _whitener() -> ctypes.CDLL:
    """Build (if needed) and load the IMU whiteners."""
    global _WHITENER_LIB
    with _LOCK:
        if _WHITENER_LIB is None:
            lib = _build(_WHITENER_SRC, WHITENER_FLAGS)
            lib.imu_whiteners.restype = None
            lib.imu_whiteners.argtypes = [
                _F64P, _F64P, _F64P, _I64, _I64, _F64, _F64, _F64, _F64P,
            ]
            _WHITENER_LIB = lib
        return _WHITENER_LIB


def _builds(loader) -> bool:
    try:
        loader()
    except (RuntimeError, OSError):
        return False
    return True


def available() -> bool:
    """Whether the ingest library (time join, interning, packing) builds and loads."""
    return _builds(_ingest)


def bag_available() -> bool:
    """Whether the bag scanner builds and loads."""
    return _builds(load)


def whitener_available() -> bool:
    """Whether the whitener library builds and loads."""
    return _builds(_whitener)


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


def approx_time_join(pivot_t, other_ts, slop: float):
    """:func:`uslam_tpu_torch.io.timesync.approximate_time_join` of one or
    two streams against the pivot, natively: a list of (pivot index,
    [index in each other stream]). Other stream counts raise ValueError
    (the JAX package hands them to its Python join)."""
    if len(other_ts) not in (1, 2):
        raise ValueError(
            f"approx_time_join joins 1 or 2 streams, got {len(other_ts)}: "
            "use io.timesync.approximate_time_join"
        )
    lib = _ingest()
    pivot = np.ascontiguousarray(pivot_t, np.float64)
    s1 = np.ascontiguousarray(other_ts[0], np.float64)
    s2 = np.ascontiguousarray(other_ts[1], np.float64) if len(other_ts) == 2 else np.zeros(0)
    op, o1, o2 = (np.empty(len(pivot), np.int64) for _ in range(3))
    n = lib.approx_time_join2(pivot, len(pivot), s1, len(s1), s2, len(s2), slop, op, o1, o2)
    if len(other_ts) == 1:
        return [(int(op[i]), [int(o1[i])]) for i in range(n)]
    return [(int(op[i]), [int(o1[i]), int(o2[i])]) for i in range(n)]


def intern_ids(ids) -> tuple[np.ndarray, int]:
    """ids (n,) int64 -> (dense rows (n,), number of distinct ids), rows in
    order of first appearance."""
    lib = _ingest()
    ids = np.ascontiguousarray(ids, np.int64)
    rows = np.empty(len(ids), np.int64)
    m = lib.intern_ids(ids, len(ids), rows)
    return rows, int(m)


def pack_imu_intervals(imu_6col, lo, hi, S: int, dt: float):
    """(T, 6) float64 samples and interval bounds [lo, hi) -> ((n, S, 7)
    with columns acc, gyro, dt, samples past S dropped; mask (n,), 1 where
    the interval holds a sample)."""
    imu = np.ascontiguousarray(imu_6col, np.float64)
    lo = np.ascontiguousarray(lo, np.int64)
    hi = np.ascontiguousarray(hi, np.int64)
    # The C loop reads rows [lo, min(hi, lo + S)) of imu unchecked.
    read = hi > lo
    if imu.ndim != 2 or imu.shape[1] != 6 or lo.ndim != 1 or hi.shape != lo.shape or S < 0 \
            or np.any(read & ((lo < 0) | (np.minimum(hi, lo + S) > len(imu)))):
        raise ValueError(
            f"pack_imu_intervals: imu {imu.shape}, lo {lo.shape}, hi {hi.shape}, S {S}: "
            "intervals must lie inside the (T, 6) samples"
        )
    lib = _ingest()
    out = np.zeros((len(lo), S, 7))
    mask = np.zeros(len(lo))
    lib.pack_imu_intervals(imu, len(imu), lo, hi, len(lo), S, dt, out, mask)
    return out, mask


def imu_whiteners(acc, gyro, dt, accel_cov, gyro_cov, integration_cov) -> np.ndarray:
    """Preintegration whiteners inv(chol(P)) over (F, S) intervals, (F, 9,
    9) float64: the recursion of
    :func:`uslam_tpu_torch.graph.builder.compute_imu_whiteners`, in C++."""
    acc = np.ascontiguousarray(acc, np.float64)
    gyro = np.ascontiguousarray(gyro, np.float64)
    dt = np.ascontiguousarray(dt, np.float64)
    if acc.ndim != 3 or acc.shape[2] != 3 or gyro.shape != acc.shape \
            or dt.shape != acc.shape[:2]:
        raise ValueError(f"imu_whiteners: acc {acc.shape}, gyro {gyro.shape}, dt {dt.shape}")
    lib = _whitener()
    F, S, _ = acc.shape
    out = np.empty((F, 9, 9), np.float64)
    lib.imu_whiteners(acc, gyro, dt, F, S, accel_cov, gyro_cov, integration_cov, out)
    return out
