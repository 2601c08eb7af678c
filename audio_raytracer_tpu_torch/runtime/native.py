"""Build and load the native C++ scene registry (ctypes binding).

The port's own loader for ``native/scene_registry.cpp``, the C++ source
both packages share at the repository root. The library compiles with
g++ at first use (no other dependency) into the git-ignored
``audio_raytracer_tpu_torch/_build/``, named by a hash of the source and
flags, so an edited source rebuilds. Several processes may load it at
once (the tests run in parallel workers): each build goes to a temporary
name under an exclusive file lock and is renamed into place, so no
process ever loads a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE_DIR), "native",
                      "scene_registry.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libaudio_rt_scene-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the library to ``path`` unless another process has; the
    file lock serializes builders, the rename publishes a whole file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "audio_rt_scene.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return
            tmp = f"{path}.{os.getpid()}.tmp"
            out = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {SOURCE}:\n{out.stderr}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The native registry library, building it if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        I64 = ctypes.c_int64
        FP = ctypes.POINTER(ctypes.c_float)
        signatures = {
            "art_registry_create": (P, []),
            "art_registry_destroy": (None, [P]),
            "art_add": (I64, [P, I, FP]),
            "art_update": (I, [P, I64, FP]),
            "art_remove": (I, [P, I64]),
            "art_handle_slot": (I, [P, I64]),
            "art_add_target": (I, [P, F, F, F]),
            "art_set_target_position": (I, [P, I, F, F, F]),
            "art_remove_target": (I, [P, I]),
            "art_update_job_batch": (I, [P]),
            "art_version": (ctypes.c_uint64, [P]),
            "art_counts": (None, [P, ctypes.POINTER(I)]),
            "art_job_data": (FP, [P, I]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib
