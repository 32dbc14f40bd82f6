"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded through ``ctypes``: no PyTorch headers, so a build takes
seconds. Libraries land in ``build/repro_torch_kernels/<hash>/`` at the root
of the checkout (git-ignored); the hash covers the sources and the flags, so
an edited kernel rebuilds and an unchanged one loads from disk. All sources
compile in parallel, one ``nvcc`` process each, on the first kernel call of a
process. A missing ``nvcc`` or a failed build raises: there is no fallback.

Flags: ``-O3 -arch=sm_90a`` and no ``--use_fast_math`` — the quantize kernels
need IEEE division and ``rintf`` to match the plain versions byte for byte,
AdamW (``adamw.cu``) IEEE division and square root, and flash attention
``expf``. No library beyond the CUDA runtime is linked:
the tensor-core flash kernel (``flash_wgmma.cu``) finds
``cuTensorMapEncodeTiled`` in the already loaded ``libcuda.so.1`` with
``dlsym``; it and the backward (``flash_wgmma_bwd.cu``) share the header
``flash_wgmma.cuh``, which the hash covers too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_ROOT = os.path.join(REPO_ROOT, "build", "repro_torch_kernels")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("chunk_delta", "quantize", "flash_attention", "flash_wgmma",
           "flash_wgmma_bwd", "adamw")
HEADERS = ("flash_wgmma.cuh",)          # included by the sources above

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the extern "C" launchers; every launcher returns the
# cudaError_t of its launch (0 = success)
SIGNATURES = {
    "chunk_delta": {"fp_launch": [_P, _L, _I, _I, _I, _P, _P, _P, _P],
                    "cm_launch": [_P, _P, _I, _P, _P]},
    "quantize": {"gq8_launch": [_P, _L, _I, _I, _I, _I, _P, _I, _P, _P, _P],
                 "gq4_launch": [_P, _L, _I, _I, _I, _I, _P, _I, _P, _P, _P],
                 "qr_launch": [_P, _L, _I, _I, _I, _P, _P, _P],
                 "dq_launch": [_P, _P, _I, _I, _L, _I, _P, _P]},
    "flash_attention": {"fa_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _F, _I, _I, _I, _I, _P],
                        "fa_combine_launch": [_P, _P, _P, _P, _L, _I, _I,
                                              _I, _P]},
    "flash_wgmma": {"fa_wgmma_launch": [_P] * 7 + [_LP] + [_I] * 6
                    + [_F] + [_I] * 4 + [_P]},
    "flash_wgmma_bwd": {"fa_wgmma_bwd_launch": [_P] * 10 + [_LP] + [_I] * 6
                        + [_F, _I, _I, _P]},
    "adamw": {"adamw_sumsq_launch": [_I, _LP, _LP, _IP, _P, _P],
              "adamw_finish_launch": [_P, _L, _F, _P, _P, _P],
              "adamw_update_launch": [_I, _I, _I, _LP, _LP, _IP] + [_P] * 4
              + [_F] * 6 + [_P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}       # ptxas resource report per source

# kernel launches so far in this process, by kernel (see ``launched``)
launches = dict.fromkeys(
    ("fingerprint", "fingerprint_changed", "changed_mask", "gather_quantize",
     "gather_quantize4", "quantize_rows", "dequantize_rows",
     "flash_attention", "flash_attention_bwd", "adamw_sumsq", "adamw_finish",
     "adamw_update"), 0)
_count_lock = threading.Lock()       # the checkpoint writer thread launches too


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built")


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*(s + ".cu" for s in SOURCES), *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _build_all(out_dir: str):
    """Compile every missing library, all nvcc processes at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded ctypes library of one source, building all on first use."""
    with _lock:
        if name not in _libs:
            out_dir = _build_dir()
            _build_all(out_dir)
            for src in SOURCES:
                lib = ctypes.CDLL(os.path.join(out_dir, f"lib{src}.so"))
                for fn, argtypes in SIGNATURES[src].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[src] = lib
        return _libs[name]


def check(err: int, kernel: str):
    """Raise on a launcher's nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: cudaError {err}")


def launched(err: int, kernel: str):
    """Raise on a launcher's nonzero cudaError_t, else count one launch of
    ``kernel`` in ``launches``. Every wrapper calls it right after its
    launcher, and nothing else counts."""
    check(err, kernel)
    with _count_lock:
        launches[kernel] += 1
