"""Build, load and count the port's hand-written CUDA kernels.

The sources under `preworld_tpu_torch/csrc/` are compiled with `nvcc` for
`sm_90a` into one shared library with a plain C interface, at first use,
into `preworld_tpu_torch/build/<hash of the sources>/`, and loaded with
ctypes. Nothing here runs at import time: the CPU tests import every module
and never reach a kernel.

`launches` counts, per kernel wrapper, the calls that launched the kernel
(plain-version calls on CPU tensors are not counted); a backward kernel
chain counts under its own name (`*_bwd`).
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

KERNELS = ("fused_swin_attn_block", "fused_swin_mlp", "plane_sweep_cost_hom",
           "bev_pool_fused", "fused_swin_attn_block_bwd", "fused_swin_mlp_bwd",
           "fused_window_attention", "band_window_attention",
           "fused_window_attention_bwd", "band_window_attention_bwd",
           "plane_sweep_cost")
launches = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pw_swin_attn_block": [_P] * 14 + [_I] * 9 + [_F, _P],
    "pw_swin_mlp": [_P] * 11 + [_I] * 3 + [_P],
    "pw_plane_sweep_cost_hom": [_P] * 4 + [_I] * 5 + [_F, _P],
    "pw_plane_sweep_cost_grid": [_P] * 4 + [_I] * 5 + [_F, _P],
    "pw_bev_pool_intervals": [_P] * 9 + [_I] * 3 + [_P],
    "pw_bev_pool_slices": [_I],
    "pw_swin_attn_block_bwd": [_P] * 23 + [_I] * 9 + [_F, _P],
    "pw_swin_attn_block_bwd_part_elems": [_I] * 6,
    "pw_swin_mlp_bwd": [_P] * 19 + [_I] * 3 + [_P],
    "pw_swin_mlp_bwd_part_elems": [_I] * 3,
    "pw_window_attn_packed": [_P] * 4 + [_I] * 5 + [_F, _P],
    "pw_window_attn_band": [_P] * 4 + [_I] * 6 + [_F, _P],
    "pw_window_attn_bwd_part_elems": [_I] * 3,
    "pw_window_attn_packed_bwd": [_P] * 7 + [_I] * 5 + [_F, _P],
    "pw_window_attn_band_bwd": [_P] * 7 + [_I] * 6 + [_F, _P],
    "pw_tensor_map_encodes": [],
    "pw_dw_splits": [_I] * 4,
    "pw_gemm_dw_part_elems": [_I] * 4,
    "pw_gemm_dw": [_P] * 7 + [_I] * 3 + [_P],
    "pw_gemm_dx": [_P] * 3 + [_I] * 3 + [_P],
}
_RESTYPES = {"pw_swin_attn_block_bwd_part_elems": ctypes.c_longlong,
             "pw_swin_mlp_bwd_part_elems": ctypes.c_longlong,
             "pw_window_attn_bwd_part_elems": ctypes.c_longlong,
             "pw_tensor_map_encodes": ctypes.c_longlong,
             "pw_gemm_dw_part_elems": ctypes.c_longlong}

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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    obj_dir = out_dir / ("obj" + tag)
    obj_dir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        tmp = out_dir / (LIB_NAME + tag)
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    seconds = time.perf_counter() - t0
    shutil.rmtree(obj_dir, ignore_errors=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    tmp.replace(lib_path)
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log="\n".join(log))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = handle
    return _lib


def tensor_map_encodes() -> int:
    """TMA tensor maps the Hopper GEMM has encoded since the library loaded
    (its cache's misses)."""
    return int(lib().pw_tensor_map_encodes())


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


def bf16(t: torch.Tensor, name: str, shape):
    """A weight matrix as a contiguous bf16 CUDA tensor (cast at use, as
    the forward and backward kernels read it)."""
    return require(t.to(torch.bfloat16).contiguous(), name, torch.bfloat16,
                   shape)


def f32(t: torch.Tensor | None, name: str, numel: int):
    """A small parameter vector as a contiguous f32 CUDA tensor."""
    if t is None:
        return None
    if t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got {t.numel()}")
    return t.reshape(-1).to(torch.float32).contiguous()


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
