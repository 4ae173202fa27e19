"""Build and load the port's CUDA kernels.

`csrc/netsim_kernels.cu` has a plain C interface, so it compiles with
`nvcc` alone (no PyTorch headers) into a shared library that `ctypes`
loads.  The build happens at first use, into `build/repro_torch/` at the
root of the checkout, under a name keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.

Every wrapper counts its launches in `LAUNCHES`: one per kernel launch,
and nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "netsim_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

KERNELS = ("plane_split", "pair_fractions", "bottleneck",
           "bucket_load_bottleneck", "queue_update", "nic_update",
           "jsq_route", "plb_select")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

# wall seconds of the last build in this process (0.0 = loaded a cached
# library or never built)
build_seconds = 0.0

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double
_ARGTYPES = {
    "plane_split": (_P, _P, _P, _P, _I64, _I, _I, _D, _D, _P),
    "pair_fractions": (_P, _P, _P, _P, _I64, _I, _D, _D, _D, _D, _P),
    "bottleneck": (_P, _P, _P, _I64, _D, _P),
    "bucket_load_bottleneck": (_P, _P, _P, _P, _P, _I64, _I, _I64, _I, _D,
                               _P),
    "queue_update": (_P, _P, _P, _P, _P, _I64, _D, _D, _P),
    "nic_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                   ctypes.POINTER(_D), _P),
    "jsq_route": (_P, _P, _P, _P, _P, _I64, _I, _D, _D, _D, _P),
    "plb_select": (_P, _P, _P, _P, _P, _P, _I64, _I, _P),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the per-packet kernels compute in float32 only, as their Pallas bodies
_FLOAT32_ONLY = ("jsq_route", "plb_select")
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnetsim_kernels_{key}.so"


def build() -> Path:
    """Compile the kernels if no library for this source exists yet.
    The compiler's resource report (`-Xptxas -v`) is kept beside the
    library as `<name>.log`."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use).  Raises when no
    CUDA device is present: the kernels never run on the CPU."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the netsim kernels run only "
                           "on the GPU (CPU tensors take the plain path)")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ARGTYPES.items():
        for suffix in (("f32",) if name in _FLOAT32_ONLY
                       else _SUFFIX.values()):
            fn = getattr(lib, f"netsim_{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(name: str, t: torch.Tensor, *, device: torch.device,
          dtype: torch.dtype, shape) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — the layout the kernels index by hand."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def float_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {t.dtype}; the kernels take "
                         "float32 or float64")
    return t.dtype


def cuda_device(name: str, t: torch.Tensor) -> torch.device:
    """`t`'s device when it is a CUDA device; raises otherwise (callers
    send CPU tensors to the plain versions before asking)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device}; the kernel "
                         "takes CUDA tensors (CPU tensors take the plain "
                         "version)")
    return t.device


def launch(kernel: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Launch one kernel on the current stream of `device`, raise if
    the launch was refused, and count it."""
    fn = getattr(library(), f"netsim_{kernel}_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1
