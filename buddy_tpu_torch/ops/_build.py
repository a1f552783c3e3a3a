"""Build the native code of ``csrc/`` at first use and load it with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``buddy_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
covers the source, the headers of ``csrc/`` and the flags, so an edited
source or header is rebuilt).  The build
directory is listed in ``.gitignore``.  ``build()`` starts one ``nvcc`` per
missing library, all at once.

The host library of the data pipeline (``csrc/wavio.cpp``, ``csrc/loader.cpp``:
the WAV codec and the threaded batch loader) is compiled the same way by the
host's C++ compiler (``$CXX``, else ``g++``) into
``_build/libhost_runtime-<hash>.so`` (``build_host``, ``load_host``); it
needs no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("stft", "subband_conv", "groupnorm", "filter_design", "wpe_solve", "minphase",
           "spec_loss", "qconv", "qconv_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_SOURCES = ("wavio.cpp", "loader.cpp")
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
HOST_LIBS = ("-lpthread",)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _hashed_path(stem: str, paths, flags) -> str:
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return _hashed_path(name, [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers],
                        NVCC_FLAGS)


def host_library_path() -> str:
    return _hashed_path("host_runtime", [os.path.join(CSRC_DIR, s) for s in HOST_SOURCES],
                        HOST_FLAGS + HOST_LIBS)


def build(names=SOURCES) -> dict:
    """Compile every missing library in ``names`` in parallel.

    Returns {name: seconds} for the libraries compiled by this call; the
    compiler's ``-Xptxas=-v`` report is kept beside each library as ``.log``.
    Raises with the compiler's output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def build_host():
    """Compile the host library if it is missing; returns the compiler's
    seconds, or None if it was there.  Raises with the compiler's output if
    the build fails."""
    out = host_library_path()
    if os.path.exists(out):
        return None
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++): the data pipeline's host library "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    run = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp,
                          *[os.path.join(CSRC_DIR, s) for s in HOST_SOURCES], *HOST_LIBS],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{cxx} failed for the host library:\n{run.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load_host(signatures: dict) -> ctypes.CDLL:
    """The loaded host library, built first if missing, with each function's
    ``restype`` and ``argtypes`` set from ``signatures`` ({function: (restype,
    [argtypes])})."""
    with _lock:
        lib = _libs.get("host_runtime")
        if lib is None:
            build_host()
            lib = ctypes.CDLL(host_library_path())
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs["host_runtime"] = lib
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` with ``argtypes`` set from ``signatures``
    ({function: [ctypes types]}); every function returns a cudaError_t."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
