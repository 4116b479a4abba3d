"""Build the hand-written kernels (csrc/*.cu) with nvcc and load them with
ctypes.

Each source builds into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), named by a hash of the
sources and flags and written to build/kernels/ at the repository root.
The first call builds every kernel source at once, one nvcc process each,
all started together; later calls in any process load the cached files.
Nothing here runs at import time.

The same directory holds two host builds, compiled with the system C++
compiler: the kernels' per-thread arithmetic (csrc/ed25519_host.cpp over
the csrc/*.cuh headers), which the CPU tests use, and the native host
packer (csrc/hostaccel.cpp), which the pack paths call on every commit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
NATIVE_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
NATIVE_ABI = 1

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C entry: argtypes}; every entry returns int (a cudaError_t)
KERNELS = {
    "ed25519_verify.cu": {"cbt_ed25519_verify": [_P, _I, _P, _P, _P]},
    "tally_quorum.cu": {
        "cbt_tally_quorum": [_P, _P, _I, _I, _P, _P, _P, _P],
        "cbt_tally_quorum_cached": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
        "cbt_carry_quorum": [_P, _I, _I, _P, _P, _P, _P],
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
    "cbt_host_carry_quorum": ([_P, _I, _I, _P, _P, _P], None),
    "cbt_host_op_counts": ([ctypes.POINTER(ctypes.c_longlong)] * 2, None),
    "cbt_host_sha_blocks": ([], ctypes.c_longlong),
}

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_N = ctypes.c_uint64
_PACK_OUT = [_I32] * 6 + [_U8]  # ay, asign, ry, rsign, sdig, hdig, precheck
# csrc/hostaccel.cpp's C entries (the JAX package's ABI, version NATIVE_ABI)
_NATIVE_FNS = {
    "batch_sha512": ([_U8, _U64, _U64, _N, _U8], None),
    "ed25519_batch_digest": ([_U8, _U8, _U8, _U64, _U64, _N, _U8], None),
    "ed25519_batch_challenge": ([_U8, _U8, _U8, _U64, _U64, _N, _U8], None),
    "batch_reduce_mod_l": ([_U8, _N, _U8], None),
    "ed25519_pack": ([_U8, _U8, _U8, _U64, _U64, _N] + _PACK_OUT, None),
    "ed25519_pack_commits": ([_U8, _U8, _U8, _U64, _U64, _U64, _U64, _I32,
                              _I64, _I64, _N] + _PACK_OUT, None),
    "batch_keccak_f1600": ([_U64, _N], None),
    "sr25519_batch_challenges": ([_U8, _I, _I, _I, _U8, _N, _U8, _U8, _N,
                                  _U8], None),
    "hostaccel_abi_version": ([], ctypes.c_int),
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


# callables run with the wall seconds of every build_all that built
# something (libs/deviceledger.arm_compile_listener adds one)
BUILD_LISTENERS: list = []


def build_all() -> None:
    """Build every kernel source that has no cached library."""
    global build_log
    todo = [s for s in KERNELS if not _target(s, NVCC_FLAGS).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    build_log = _finish([_start(nvcc, s, NVCC_FLAGS, _target(s, NVCC_FLAGS))
                         for s in todo])
    secs = time.perf_counter() - t0
    for fn in list(BUILD_LISTENERS):
        fn(secs)


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


def _host_build(src: str, flags, fns: dict, key) -> ctypes.CDLL:
    """csrc/<src> built with the host C++ compiler (cached like the
    kernels) and loaded with `fns` declared; the caller holds _lock."""
    lib = _libs.get(key)
    if lib is None:
        out = _target(src, flags)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise BuildError("no C++ compiler on PATH")
            _finish([_start(cxx, src, flags, out)])
        lib = _load(out, fns)
        _libs[key] = lib
    return lib


def host_lib(count_ops: bool = False) -> ctypes.CDLL:
    """The host build of csrc/ed25519_host.cpp (C++ compiler, no CUDA)."""
    flags = HOST_FLAGS + (("-DCBT_COUNT_OPS",) if count_ops else ())
    with _lock:
        return _host_build("ed25519_host.cpp", flags, _HOST_FNS,
                           ("host", count_ops))


def native_lib() -> ctypes.CDLL:
    """The native host packer, csrc/hostaccel.cpp (C++ compiler, no
    CUDA), with its C entries declared; raises BuildError when there is
    no compiler, the build fails or the library's ABI is not NATIVE_ABI."""
    with _lock:
        fresh = "native" not in _libs
        lib = _host_build("hostaccel.cpp", NATIVE_FLAGS, _NATIVE_FNS,
                          "native")
        if fresh and lib.hostaccel_abi_version() != NATIVE_ABI:
            del _libs["native"]
            raise BuildError(f"hostaccel ABI {lib.hostaccel_abi_version()}"
                             f", want {NATIVE_ABI}")
        return lib
