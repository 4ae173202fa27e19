"""Build and load the port's CUDA kernels.

The sources in `csrc/` (`netsim_kernels.cu`, the simulator's kernels, and
`model_kernels.cu`, attention and the int8 codec) have a plain C
interface, so they compile with `nvcc` alone (no PyTorch headers), one
`nvcc` per source started together, and link into one shared library
that `ctypes` loads.  The build happens at first use, into
`build/repro_torch/` at the root of the checkout, under a name keyed by
a hash of every source and the flags, so an edited source rebuilds and
an unchanged one loads at once.

Every wrapper counts its launches in `LAUNCHES`: one per call of a
kernel's C entry point, and nowhere else, so a run can show that it went
through the kernels.  A call made while the stream is being captured
into a CUDA graph launches nothing; it is recorded in `RECORDED`, and
each replay of the graph counts the launches its capture recorded
(`count_replay`, `netsim/graph.py`).
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "netsim_kernels.cu", CSRC / "model_kernels.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "--fmad=false", "-std=c++17", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double
_PP, _PI64 = ctypes.POINTER(_P), ctypes.POINTER(_I64)
_F32_F64 = (torch.float32, torch.float64)
_F32_BF16 = (torch.float32, torch.bfloat16)
# kernel -> (C symbol prefix, dtypes it is built for, argument types);
# the entry point of `kernel` in `dtype` is `{prefix}_{kernel}_{suffix}`
_ENTRIES = {
    "plane_split": ("netsim", _F32_F64,
                    (_P, _P, _P, _P, _I64, _I, _I, _D, _D, _P)),
    "pair_fractions": ("netsim", _F32_F64,
                       (_P, _P, _P, _P, _I64, _I, _D, _D, _D, _D, _P)),
    # arrays of up to four (cap, load, out) pointers and lengths, and
    # their count: one launch for all of them
    "bottleneck": ("netsim", _F32_F64, (_PP, _PP, _PP, _PI64, _I, _D, _P)),
    # rate, plan, cap, load, frac, then lanes B, flows F, planes P, rows
    # R, plan width C
    "bucket_load_bottleneck": ("netsim", _F32_F64,
                               (_P, _P, _P, _P, _P, _I64, _I64, _I, _I64,
                                _I, _D, _P)),
    # arrays of one or two (q, load, cap, q_new, util) pointers and
    # lengths, and their count: one launch for both
    "queue_update": ("netsim", _F32_F64,
                     (_PP, _PP, _PP, _PP, _PP, _PI64, _I, _D, _D, _P)),
    "nic_update": ("netsim", _F32_F64,
                   (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                    ctypes.POINTER(_D), _P)),
    # the per-packet kernels compute in float32 only, as their Pallas
    # bodies do
    "jsq_route": ("netsim", (torch.float32,),
                  (_P, _P, _P, _P, _P, _I64, _I, _D, _D, _D, _P)),
    "plb_select": ("netsim", (torch.float32,),
                   (_P, _P, _P, _P, _P, _P, _I64, _I, _P)),
    "flash_attention": ("model", _F32_BF16,
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I64,
                         _I64, _I64, _I64, _I64, _I64, _I, _I, _D, _P)),
    # q, k, v, lengths, the partials, out; B * H, H, Hkv, S, D, the
    # chunks; the batch and head strides of q, the batch, head and
    # sequence strides of k and of v (elements); the scale
    "decode_attention": ("model", _F32_BF16,
                         (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                          _I64, _D, _P)),
    # int8_encode in the type of x, with its instance and whether it
    # takes 16-byte loads (int8_codec.encode_instance); int8_decode in
    # the output type
    "int8_encode": ("model", _F32_BF16,
                    (_P, _P, _P, _P, _I64, _I64, _I, _I, _P)),
    "int8_decode": ("model", _F32_BF16, (_P, _P, _P, _I64, _I64, _P)),
    # arrays of up to six (vals, offsets, entries, out, cap, scale)
    # pointers (cap and scale null where an entry takes no scale) and of
    # their bucket counts and log2 lanes a bucket, their count, whether
    # each bucket starts from its value in out (a chunk's fold) or from
    # 0, and the scale's eps: one launch for all
    "segment_sum": ("netsim", _F32_F64,
                    (_PP, _PP, _PP, _PP, _PP, _PP, _PI64,
                     ctypes.POINTER(_I), _I, _I, _D, _P)),
}
KERNELS = tuple(_ENTRIES)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
RECORDED: Dict[str, int] = {k: 0 for k in KERNELS}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}
MAX_GRID_Y = 65535              # CUDA's limit on gridDim.y

# wall seconds of the last build in this process (0.0 = loaded a cached
# library or never built)
build_seconds = 0.0
_LIB: Optional[ctypes.CDLL] = None


def symbol(kernel: str, dtype: torch.dtype) -> str:
    """The C entry point of `kernel` for `dtype`."""
    return f"{_ENTRIES[kernel][0]}_{kernel}_{_SUFFIX[dtype]}"


def source(kernel: str) -> Path:
    """The source that defines `kernel`: `csrc/{prefix}_kernels.cu`."""
    return CSRC / f"{_ENTRIES[kernel][0]}_kernels.cu"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_replay(recorded: Dict[str, int]) -> None:
    """Count the launches of one replay of a CUDA graph whose capture
    recorded `recorded` (kernel -> calls)."""
    for k, n in recorded.items():
        LAUNCHES[k] += n


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
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for these sources exists yet:
    one `nvcc -c` per source, all started together, then one link.  The
    compiler's resource reports (`-Xptxas -v`) are kept beside the
    library as `<name>.log`."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text[-4000:]}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stderr[-4000:]}")
    build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use).  Raises when no
    CUDA device is present: the kernels never run on the CPU."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only "
                           "on the GPU (CPU tensors take the plain path)")
    lib = ctypes.CDLL(str(build()))
    for kernel, (_, dtypes, argtypes) in _ENTRIES.items():
        for dtype in dtypes:
            fn = getattr(lib, symbol(kernel, dtype))
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


def float_dtype(kernel: str, t: torch.Tensor) -> torch.dtype:
    """`t`'s dtype when `kernel` is built for it; raises otherwise."""
    dtypes = _ENTRIES[kernel][1]
    if t.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[1] for d in dtypes)
        raise ValueError(f"{kernel}: dtype {t.dtype}; the kernel takes "
                         f"{names}")
    return t.dtype


def aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless `t`'s data starts on a 16-byte boundary (the
    kernels' vector loads need it)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data not aligned to 16 bytes")


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
    the launch was refused, and count it (record it, under capture)."""
    fn = getattr(library(), symbol(kernel, dtype))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    (RECORDED if capturing else LAUNCHES)[kernel] += 1
