"""Build, load and launch the port's CUDA kernels.

The kernels are CUDA C++ under `csrc/`, each with a plain C entry point
that returns its `cudaError_t`. At first use `library()` compiles every
source with nvcc for sm_90a (one nvcc per source, all started together),
links one shared library into `build/repro_torch/<hash>/` at the root of
the checkout, keyed by a hash of the sources and flags, and loads it with
ctypes. Nothing is compiled when the package is imported, and the CPU path
never builds. A failed build raises with nvcc's output; a build that
succeeds keeps each source's output (ptxas's registers and spills of every
kernel instance) beside the library, in `<source stem>.log`.

`launch(name, ...)` is the only place a kernel is started: it makes the C
call, raises on a CUDA error, and adds one to that kernel's launch count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

# dtype codes of csrc/common.cuh (rt::Dtype)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
SMS = 132  # the H100's streaming multiprocessors, which the plans fill

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_long)  # a host array of strides
SIGNATURES = {
    "rt_hadamard_affine": (_P, _P, _I, _P, _I, _P, _L, _I, _I, _I, _I, _I, _L,
                           _I, _I, _P),
    "rt_hadamard_affine_bwd": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _L, _I,
                               _I, _I, _I, _L, _I, _I, _P),
    "rt_fused_adapter_norm": (_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P,
                              _I, _I, _F, _I, _I, _I, _I, _I, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F,
                           _F, _I, _I, _I, _P),
    "rt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                           _P),
    "rt_multitask_hadamard": (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P),
    "rt_dequant_matmul": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P),
    "rt_masked_multitask_hadamard": (_P, _P, _I, _I, _P, _I, _I, _P, _I, _P,
                                     _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rt_wkv6": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LP, _I, _I,
                _I, _I, _I, _P),
}

# kernel name -> launches since the last reset (see launch())
LAUNCHES: Dict[str, int] = {
    "hadamard_affine": 0,
    "hadamard_affine_bwd": 0,
    "fused_adapter_norm": 0,
    "flash_attention": 0,
    "paged_attention": 0,
    "multitask_hadamard": 0,
    "dequant_matmul": 0,
    "masked_multitask_hadamard": 0,
    "wkv6": 0,
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """One nvcc per .cu source, all at once, then one link."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for cmd, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{log.decode(errors='replace')}")
            (out.parent / (obj.stem + ".log")).write_bytes(log)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                               + res.stdout.decode(errors="replace"))
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or none


def build_dir() -> Path:
    """Where the library of the checkout's sources is built, with each
    source's nvcc output."""
    return BUILD_ROOT / _source_hash()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the checkout's sources on
    first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = build_dir() / LIB_NAME
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, c_fn: str, *args) -> None:
    """Run one kernel on PyTorch's current stream; raise on a CUDA error;
    count the launch."""
    lib = library()
    err = getattr(lib, c_fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.rt_error_string(err).decode()}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_inputs(name: str, *tensors: Optional[torch.Tensor],
                 contiguous: bool = True) -> None:
    """Every given tensor lies on one CUDA device and (unless the kernel
    takes strides) is contiguous; raise otherwise."""
    given = [t for t in tensors if t is not None]
    devices = {t.device for t in given}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                         f"device (got {sorted(map(str, devices))})")
    for t in given if contiguous else ():
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors "
                             f"(got shape {tuple(t.shape)}, strides "
                             f"{t.stride()})")


def full_vec(dtype) -> int:
    """Elements of `dtype` in one 16-byte access: 8 bf16, 4 fp32."""
    return 16 // dtype.itemsize


def aligned16(*tensors: Optional[torch.Tensor]) -> bool:
    """Does every given tensor's data start on a 16-byte boundary (so
    that a kernel may load it 16 bytes at a time)?"""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def check_dtype(name: str, what: str, t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: {what} must be one of "
                        f"{[str(a) for a in allowed]} (got {t.dtype})")
    return DTYPE_CODE[t.dtype]
