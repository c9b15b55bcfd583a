"""Build, load and count the port's hand-written CUDA kernels.

==================  ==========================  ==============================
wrapper             CUDA source                 replaces (JAX package)
==================  ==========================  ==============================
``fast_harris``     ``csrc/fast_harris.cu``     Pallas ``_fast_harris_kernel``
``hamming``         ``csrc/hamming.cu``         Pallas ``_hamming_kernel``
``preintegrate``    ``csrc/preintegrate.cu``    the ``lax.scan`` of
                                                ``factors/imu.py::preintegrate``
                                                under ``jax.jacfwd`` (one row
                                                per IMU interval)
``jacobi_eigh``     ``csrc/jacobi_eigh.cu``     ``jnp.linalg.eigh`` of the
                                                online window step's marginal
                                                (``solvers/eig.py``)
``graph_cond``      ``csrc/graph_cond.cu``      the ``lax.while_loop`` and
                                                ``lax.cond`` of the LM and
                                                its CG (conditional nodes of
                                                a CUDA graph,
                                                ``solvers/compiled.py``)
==================  ==========================  ==============================

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a``, one ``nvcc``
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import), into ``uslam_tpu_torch/_build/``,
keyed by a hash of the sources and flags, so a fresh checkout builds
itself. A failed build raises; nothing falls back.

``launch_counts`` counts the kernel launches of each wrapper since the
last :func:`reset_launch_counts`. Only a launch of a CUDA kernel counts;
the plain versions never do. A replayed CUDA graph
(:mod:`uslam_tpu_torch.solvers.compiled`) adds the launches it holds; those
inside its conditional nodes' bodies, which run as often as the device
decides, are added when the host next reads the node's counts
(``compiled.read``, ``compiled.settle_launches``, and here before a reset).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts = {"fast_harris": 0, "hamming": 0, "preintegrate": 0, "jacobi_eigh": 0,
                 "graph_cond": 0}
# Run before a reset: they add the launches still counted on the device.
before_reset: list = []

_LOCK = threading.Lock()
_LIB = None
build_log = ""


def reset_launch_counts() -> None:
    for hook in before_reset:
        hook()
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return str(path)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "uslam_fast_harris": [vp, vp, vp, i32, i32, i32, f32, f32, vp],
        "uslam_fast_harris_strip_rows": [i32, i32, i32],
        "uslam_hamming": [vp, vp, vp, i32, i32, i32, vp],
        "uslam_preintegrate": [i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp],
        "uslam_jacobi_eigh": [i32, vp, vp, vp, vp, i32, i32, i32, vp],
        "uslam_cond_set": [vp, ctypes.c_ulonglong, vp, vp],
        "uslam_empty_kernel": [vp],
        "uslam_cond_node": [vp, i32, vp, vp, ctypes.POINTER(ctypes.c_ulonglong),
                            ctypes.POINTER(vp)],
        "uslam_stream_create": [ctypes.POINTER(vp)],
        "uslam_capture_to": [vp, vp],
        "uslam_capture_end": [vp],
        "uslam_graph_node_types": [vp, ctypes.POINTER(i32), i32, ctypes.POINTER(i32)],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.uslam_cuda_error_string.argtypes = [i32]
    lib.uslam_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = sorted(_CSRC.glob("*.cu"))
        digest = hashlib.sha256()
        for src in sources:
            digest.update(src.name.encode() + src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = _BUILD_DIR / f"libuslam_kernels_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            nvcc, out = _nvcc(), {"stdout": subprocess.PIPE, "stderr": subprocess.STDOUT,
                                  "text": True}
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], **out)
                     for src, obj in zip(sources, objs)]
            build_log = "".join(proc.communicate()[0] for proc in procs)
            rc = next((proc.returncode for proc in procs if proc.returncode), 0)
            if not rc:
                link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                       *map(str, objs)], **out)
                build_log, rc = build_log + link.stdout, link.returncode
            for obj in objs:
                obj.unlink(missing_ok=True)
            if rc:
                raise RuntimeError(f"nvcc failed ({rc}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _LIB = lib
        return lib


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``ndim``-d tensor of
    ``dtype`` on the CPU or a CUDA device."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def raise_on(lib, code: int, name: str) -> None:
    """Raise RuntimeError if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.uslam_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device (a capturing stream inside
    a CUDA graph capture), as the int the C interface takes."""
    return torch.cuda.current_stream(t.device).cuda_stream
