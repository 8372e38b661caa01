"""Build and load the CUDA probe kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Every ``csrc/*.cu`` compiles on its own (``build_all`` starts one ``nvcc``
per source, all at once) for ``sm_90a`` into ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of the sources, so a changed
source never loads a stale library. Nothing here runs at import: the
first launch builds what it needs. A missing ``nvcc`` or a failed build
raises; there is no fallback.

Each C entry point takes its device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch;
``check`` raises on anything but 0 (a refused launch never runs, and
``torch.cuda.synchronize()`` would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int32
U32 = ctypes.c_uint32
I64 = ctypes.c_int64
PU32 = ctypes.POINTER(ctypes.c_uint32)      # host words (a ctypes array)

# C signature of every entry point: (source stem, symbol) -> argtypes
SIGNATURES = {
    ("lsm_probe", "lsm_probe_launch"):
        [P, P, I32, P, P, P, P, I64, P],
    ("lsm_probe", "lsm_chain_probe_launch"):
        [P, P, P, P, P, I32, I32, U32, U32, U32, U32, U32, U32,
         U32, U32, U32, U32, U32, I64, P],
    ("lsm_window", "lsm_window_partition_launch"):
        [P, I32, P, P, I64, I32, P, P, P, P, P, P, P, P, P],
    ("lsm_window", "lsm_window_probe_launch"):
        [P, P, I32, I32, U32, P, P, P, P, P, P, P, I64, P],
    ("bloom_probe", "bloom_probe_launch"):
        [P, P, P, P, U32, U32, U32, U32, I64, P],
    ("bloom_onchip", "bloom_onchip_launch"):
        [P, U32, U32, I32, U32, U32, U32, U32, P, P, P, I64, I64, P],
    ("bloom_onchip", "cascade_onchip_launch"):
        [P, U32, U32, I32, P, I32, P, P, P, P, I64, I64, P],
    ("bloomier_onchip", "bloomier_onchip_launch"):
        [PU32, I32, P, P, U32, P, P, P, P, I64, I64, P],
    ("xor_probe", "bloomier_probe_launch"):
        [P, P, P, P, PU32, I64, P],
    ("chained_probe", "chained_probe_launch"):
        [P, P, P, P, P, I32, PU32, PU32, I64, P],
    ("cascade_probe", "cascade_probe_launch"):
        [P, P, I32, P, P, P, P, I64, P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}        # stem -> nvcc's output (-Xptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA probe kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def _target(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def _start(stem: str):
    """Start nvcc for one source (None when its library is already built)."""
    out = _target(stem)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(stem: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[stem] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
    os.replace(tmp, out)


def _load(stem: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(stem)))
    for (s, sym), argtypes in SIGNATURES.items():
        if s == stem:
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def stems() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every kernel source in parallel (one nvcc each) and load it."""
    with _lock:
        todo = [s for s in stems() if s not in _libs]
        started = {s: _start(s) for s in todo}
        for s in todo:
            _finish(s, started[s])
            _libs[s] = _load(s)
        return dict(_libs)


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        if stem not in _libs:
            _finish(stem, _start(stem))
            _libs[stem] = _load(stem)
        return _libs[stem]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
