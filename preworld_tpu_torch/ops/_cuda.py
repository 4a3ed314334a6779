"""Build, load and count the port's hand-written CUDA kernels.

The sources under `preworld_tpu_torch/csrc/` are compiled with `nvcc` for
`sm_90a` into one shared library with a plain C interface, at first use,
into `preworld_tpu_torch/build/<hash of the sources>/`, and loaded with
ctypes. Nothing here runs at import time: the CPU tests import every module
and never reach a kernel.

`launches` counts, per kernel wrapper, the calls that launched the kernel
(plain-version calls on CPU tensors are not counted).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "build"
LIB_NAME = "libpreworld_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

KERNELS = ("fused_swin_attn_block", "fused_swin_mlp", "plane_sweep_cost_hom",
           "bev_pool_fused")
launches = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pw_swin_attn_block": [_P] * 13 + [_I] * 9 + [_F, _P],
    "pw_swin_mlp": [_P] * 10 + [_I] * 3 + [_P],
    "pw_plane_sweep_cost_hom": [_P] * 4 + [_I] * 5 + [_F, _P],
    "pw_bev_pool_intervals": [_P] * 5 + [_I] * 2 + [_P],
}

_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels (once per source hash); return the library path."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    tmp.replace(lib_path)
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log=proc.stderr)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def f32(t: torch.Tensor | None, name: str, numel: int):
    """A small parameter vector as a contiguous f32 CUDA tensor."""
    if t is None:
        return None
    if t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got {t.numel()}")
    return t.detach().reshape(-1).to(torch.float32).contiguous()


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
