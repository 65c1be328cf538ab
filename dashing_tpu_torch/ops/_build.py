"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel file is compiled once per checkout, at first use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         [flags] -Xptxas -v -Xcompiler -fPIC \
         -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

into a directory that .gitignore lists, and loaded with ctypes.  <hash>
covers the source, every shared header (csrc/*.cuh) and the full nvcc
command line, so a change to any of them builds a new library instead of
reusing one made another way.  ptxas's report (-Xptxas -v) of each
kernel's registers, stack frame and spills is kept in `build_logs[name]`
when the library is built in this process.  The C entry points take raw
device pointers and the CUDA stream as `void*` and return
`cudaGetLastError()` after the launch; `launch` calls one on its device's
current stream, and `check` raises on anything but 0.
Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()                 # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def load(name: str, signatures: Dict[str, tuple],
         flags: Sequence[str] = (), src: str | None = None) -> ctypes.CDLL:
    """Compile csrc/<name>.cu, or the source at path `src`, (with extra
    nvcc `flags`) if needed and return the loaded library, with
    `signatures` ({function: (argtypes, restype)}) declared.  Different
    kernels may build at once from several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = src or os.path.join(CSRC, f"{name}.cu")
        opts = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", *flags,
                "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
        key = hashlib.sha256()
        for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as fp:
                key.update(fp.read())
        key.update("\0".join(opts).encode())
        so = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        # an exclusive flock serialises first builds across processes
        with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not os.path.exists(so):
                    t0 = time.perf_counter()
                    tmp = f"{so}.tmp.{os.getpid()}"
                    cmd = [nvcc(), *opts, "-o", tmp, src]
                    res = subprocess.run(cmd, capture_output=True, text=True)
                    if res.returncode != 0:
                        raise RuntimeError(f"nvcc failed for {src}:\n"
                                           f"{res.stdout}{res.stderr}")
                    os.replace(tmp, so)
                    build_seconds[name] = time.perf_counter() - t0
                    build_logs[name] = res.stdout + res.stderr
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.dtt_error_string.argtypes = [ctypes.c_int]
        lib.dtt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def launch(lib: ctypes.CDLL, entry: str, device, *args) -> None:
    """Call the C entry point `entry` of `lib` with `args` and the current
    stream of CUDA `device`, with `device` the runtime's current device
    (a kernel launch and cudaFuncSetAttribute act on the current device,
    not the stream's, and an entry may read the current device's SM
    count); raise on an error.  Every kernel launch goes through here."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    check(err, entry, lib)


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.dtt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
