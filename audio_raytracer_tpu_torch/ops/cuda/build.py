"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
All sources build in parallel, one nvcc process each, the first time any
kernel is needed. Libraries land in ``audio_raytracer_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from disk. The build holds an
exclusive lock on ``_build/lock`` (``fcntl.flock``) beside the thread
lock, so ranks of a mesh that start cold build once and load the same
libraries.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` (the miss
encodings rely on IEEE inf arithmetic and exact division), and
``--fmad=false`` so every operation rounds as the plain PyTorch versions
round it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

SOURCES = ("closest_hit", "multi_any_hit", "multi_chord",
           "multi_chord_dens_bwd", "multi_chord_bwd", "any_hit", "calibrate",
           "spans")
HEADERS = ("fields.cuh", "chord.cuh", "bvh.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output of the last build of each library (register and shared
# memory use from ``-Xptxas -v``).
build_logs: dict[str, str] = {}


def find_cuda_tool(tool: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): $CUDA_HOME/bin,
    then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", tool))
    found = shutil.which(tool)
    if found:
        cands.append(found)
    cands.append(f"/usr/local/cuda/bin/{tool}")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"{tool} not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin)")


def find_nvcc() -> str:
    """Path of nvcc, without which the CUDA kernels cannot be built."""
    return find_cuda_tool("nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def nvcc_command(nvcc: str, name: str, out: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, f"{name}.cu")]


@contextlib.contextmanager
def build_lock(directory: str = BUILD_DIR):
    """Exclusive across threads (``_lock``) and processes (``flock`` on
    ``directory/lock``, released by the kernel if the holder dies)."""
    with _lock:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "lock"), "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (in parallel) and load them all."""
    with build_lock():
        # Checked under the lock: another process may have just built.
        missing = [n for n in SOURCES
                   if n not in _libs and not os.path.exists(lib_path(n))]
        if missing:
            nvcc = find_nvcc()
            procs = {}
            for n in missing:
                tmp = f"{lib_path(n)}.{os.getpid()}.tmp"
                procs[n] = (tmp, subprocess.Popen(
                    nvcc_command(nvcc, n, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            failed = []
            for n, (tmp, p) in procs.items():
                log, _ = p.communicate()
                build_logs[n] = log
                if p.returncode != 0:
                    failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
                else:
                    os.replace(tmp, lib_path(n))
            if failed:
                raise RuntimeError("CUDA kernel build failed: "
                                   + "\n".join(failed))
        for n in SOURCES:
            if n not in _libs:
                _libs[n] = _bind(n, ctypes.CDLL(lib_path(n)))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        build_all()
    return _libs[name]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CLOSEST_HIT = [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P]
_MULTI_ANY_HIT = [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _P, _I,
                  _I, _P, _P]
_MULTI_CHORD = [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P]
# The C entry points of each library and their argument types (B1-B3's
# bfloat16 tier takes the float32 entry point's arguments, B1's and B2's
# with the card's SM count before the stream; their occupancy reports
# both tiers, B1's its tree kernel too).
_SIGNATURES = {
    "closest_hit": {
        "closest_hit": _CLOSEST_HIT,
        "closest_hit_bf16": _CLOSEST_HIT[:-1] + [_I, _P],
        "closest_hit_bvh": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                            _P, _I, _P, _P, _P, _P],
        "bvh_boxes": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _F, _F, _P],
        "bvh_tree": [_P, _P, _I, _I, _P, _P, _P, _P],
        "closest_hit_occupancy": [_P, _P, _P],
        "rcp_mismatches": [_P, _P]},
    "multi_any_hit": {
        "multi_any_hit": _MULTI_ANY_HIT,
        "multi_any_hit_bf16": _MULTI_ANY_HIT[:-1] + [_I, _P],
        "multi_any_hit_occupancy": [_I, _P, _P]},
    "multi_chord": {
        "multi_chord": _MULTI_CHORD,
        "multi_chord_bf16": _MULTI_CHORD,
        "multi_chord_bvh": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I,
                            _P, _I, _P, _P, _P, _P]},
    "multi_chord_dens_bwd": {
        "multi_chord_dens_bwd": [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I,
                                 _P, _P, _P, _P],
        "multi_chord_dens_bwd_occupancy": [_I, _P],
        "sqrt_mismatches": [_P, _P, _P]},
    "multi_chord_bwd": {
        "multi_chord_bwd": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I,
                            _P, _P, _P],
        "chord_loss_bwd": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P,
                           _P, _P]},
    "any_hit": {
        "any_hit": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P],
        "any_hit_occupancy": [_P]},
    "calibrate": {"calibrate": [_P, _I, _P, _I, _I, _I, _P, _P],
                  "calibrate_bf16x2": [_P, _I, _P, _I, _I, _I, _P, _P]},
    "spans": {"span_mark": [_I, _I, _P, _P], "span_count": [_P]},
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed with cudaError_t {err}")
