"""Build the hand-written kernels (csrc/*.cu) with nvcc and load them with
ctypes.

Each source builds into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), named by a hash of the
sources and flags and written to build/kernels/ at the repository root.
The first call builds every kernel source at once, one nvcc process each,
all started together; later calls in any process load the cached files.
Nothing here runs at import time.

The same directory holds the host build of the kernels' per-thread
arithmetic (csrc/ed25519_host.cpp over the csrc/*.cuh headers, compiled
with the system C++ compiler), which the CPU tests use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C entry: argtypes}; every entry returns int (a cudaError_t)
KERNELS = {
    "ed25519_verify.cu": {"cbt_ed25519_verify": [_P, _I, _P, _P, _P]},
    "tally_quorum.cu": {
        "cbt_tally_quorum": [_P, _P, _I, _I, _P, _P, _P, _P],
        "cbt_tally_quorum_cached": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    },
    "valset_table.cu": {
        "cbt_valset_table_build_quad": [_P, _P, _I, _P, _P, _P, _P],
        "cbt_valset_table_build_warp": [_P, _P, _I, _P, _P, _P, _P]},
    "ed25519_cached_verify.cu": {
        "cbt_ed25519_verify_cached": [_P, _I, _P, _I, _P, _P, _P, _P],
        "cbt_ed25519_verify_cached_thread": [_P, _I, _P, _I, _P, _P, _P,
                                             _P]},
    "stamp_rows.cu": {"cbt_stamp_rows": [
        _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I,
        _P, _P]},
    "sr25519_verify.cu": {"cbt_sr25519_verify": [_P, _I, _P, _P, _P]},
    "ecdsa_verify.cu": {"cbt_ecdsa_verify": [_P, _I, _P, _P, _P]},
}
_HOST_FNS = {
    "cbt_host_verify": ([_P, _I, _P, _P], None),
    "cbt_host_verify_quad": ([_P, _I, _P, _P], None),
    "cbt_host_sr25519_verify": ([_P, _I, _P, _P], None),
    "cbt_host_sr25519_verify_quad": ([_P, _I, _P, _P], None),
    "cbt_host_ecdsa_verify": ([_P, _I, _P, _P], None),
    "cbt_host_ecdsa_verify_quad": ([_P, _I, _P, _P], None),
    "cbt_host_secp_quad_pt": ([_I, _P, _P, _I, _P], None),
    "cbt_host_secp_fe": ([_I, _P, _P, _I, _P], None),
    "cbt_host_table_build": ([_P, _I, _P, _P], None),
    "cbt_host_table_build_quad": ([_P, _I, _P, _P], None),
    "cbt_host_table_build_warp": ([_P, _I, _P, _P], None),
    "cbt_host_verify_cached": ([_P, _I, _P, _I, _P, _P, _P], None),
    "cbt_host_verify_cached_quad": ([_P, _I, _P, _I, _P, _P, _P], None),
    "cbt_host_stamp": ([_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P,
                        _I, _P, _I, _I, _P], None),
    "cbt_host_sc_reduce": ([_P, _P], None),
    "cbt_host_tally": ([_I, _P, _P, _I, _P, _I, _I, _P, _P], ctypes.c_int),
    "cbt_host_op_counts": ([ctypes.POINTER(ctypes.c_longlong)] * 2, None),
    "cbt_host_sha_blocks": ([], ctypes.c_longlong),
}

_lock = threading.Lock()
_libs: dict = {}
build_log = ""  # compiler output of the last nvcc build (ptxas registers)


class BuildError(RuntimeError):
    pass


def _digest(src: str, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((CSRC / src).read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def _target(src: str, flags) -> Path:
    return BUILD_DIR / f"{Path(src).stem}-{_digest(src, flags)}.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")


def _start(compiler: str, src: str, flags, out: Path):
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(jobs) -> str:
    errors, logs = [], []
    for proc, tmp, out, cmd in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        logs.append(log)
        os.replace(tmp, out)
    if errors:
        raise BuildError("kernel build failed:\n" + "\n".join(errors))
    return "".join(logs)


def build_all() -> None:
    """Build every kernel source that has no cached library."""
    global build_log
    todo = [s for s in KERNELS if not _target(s, NVCC_FLAGS).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    build_log = _finish([_start(nvcc, s, NVCC_FLAGS, _target(s, NVCC_FLAGS))
                         for s in todo])


def _load(path: Path, fns: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in fns.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def kernel_lib(src: str) -> ctypes.CDLL:
    """The loaded library of csrc/<src>, building all kernels if needed;
    its C entries have their argtypes declared and return int."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            build_all()
            lib = _load(_target(src, NVCC_FLAGS),
                        {n: (a, ctypes.c_int)
                         for n, a in KERNELS[src].items()})
            _libs[src] = lib
        return lib


def host_lib(count_ops: bool = False) -> ctypes.CDLL:
    """The host build of csrc/ed25519_host.cpp (C++ compiler, no CUDA)."""
    flags = HOST_FLAGS + (("-DCBT_COUNT_OPS",) if count_ops else ())
    key = ("host", count_ops)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            out = _target("ed25519_host.cpp", flags)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                cxx = shutil.which("c++") or shutil.which("g++")
                if cxx is None:
                    raise BuildError("no C++ compiler on PATH")
                _finish([_start(cxx, "ed25519_host.cpp", flags, out)])
            lib = _load(out, _HOST_FNS)
            _libs[key] = lib
        return lib
