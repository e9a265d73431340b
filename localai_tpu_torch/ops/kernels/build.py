"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) and is loaded with ctypes. The libraries land in
``build/`` next to this file (git-ignored), named by a hash of the
sources and flags, so an unchanged source is built once per checkout.
All stale libraries build in parallel: one ``nvcc`` per source, started
together. Nothing builds at import time; the first launch (or an explicit
``build_all``) does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from localai_tpu_torch.services import sysobs

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", "-lineinfo"] + ARCH_FLAGS

_P = ctypes.c_void_p
_I = ctypes.c_int
# C launchers of each library, {source name: {function: argtypes}}
# (pointers and the stream as void*, ints as int)
SIGNATURES = {
    "paged_decode": {
        "paged_decode_attention_launch": [_P] * 9 + [_I] * 9 + [_P],          # K1
        "paged_decode_attention_quant_launch": [_P] * 11 + [_I] * 9 + [_P],   # K3
    },
    "ragged_prefill": {
        "ragged_prefill_attention_launch": [_P] * 11 + [_I] * 10 + [_P],      # K2
        "ragged_prefill_attention_quant_launch": [_P] * 13 + [_I] * 10 + [_P],  # K2-int8
    },
    "contig_decode": {
        "contig_decode_attention_launch": [_P] * 8 + [_I] * 7 + [_P],         # K4
        "contig_decode_attention_full_launch": [_P] * 9 + [_I] * 9 + [_P],    # K5
    },
    "quant_matmul": {
        "quant_matmul_tc_launch": [_P] * 5 + [_I] * 7 + [_P],                 # W8 / W4 bf16
        "quant_matmul_skinny_launch": [_P] * 5 + [_I] * 7 + [_P],             # W8 / W4 f32
        "quant_dequant_launch": [_P] * 3 + [_I] * 5 + [_P],                   # f32 wide, table
    },
}

_lock = threading.Lock()
_libs: dict = {}
# name -> {"seconds": build wall time, "log": nvcc output} for the last build
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names=None) -> dict:
    """Compile every stale kernel library in parallel; returns
    {name: seconds} for the ones built now. Raises with nvcc's output on
    any failure."""
    names = list(names or SIGNATURES)
    with _lock:
        todo = [n for n in names if not os.path.isfile(_lib_path(n))]
        if not todo:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.monotonic()
        for n in todo:
            out = _lib_path(n)
            cmd = [nvcc, *NVCC_FLAGS, "-o", out + ".tmp",
                   os.path.join(CSRC, f"{n}.cu")]
            procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
        failed = []
        for n, p in procs.items():
            log, _ = p.communicate()
            BUILD_INFO[n] = {"seconds": time.monotonic() - t0, "log": log}
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {p.returncode}) ---\n{log}")
            else:
                os.replace(_lib_path(n) + ".tmp", _lib_path(n))
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        built = {n: BUILD_INFO[n]["seconds"] for n in todo}
    # a build on an engine thread counts as a compile there (a build after
    # the engine's start is a compile storm: services/sysobs.py)
    for n, secs in built.items():
        sysobs.note_compile(f"build:{n}", secs)
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``name``.cu (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def launcher(name: str, fn_name: str):
    """The C launcher ``fn_name`` of the library built from ``name``.cu."""
    if fn_name not in SIGNATURES[name]:
        raise KeyError(f"{name}.cu has no launcher {fn_name}")
    return getattr(library(name), fn_name)


def check(err: int, what: str):
    """Raise when a launcher reported a CUDA error (launch refused or
    shapes the kernel does not take)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
