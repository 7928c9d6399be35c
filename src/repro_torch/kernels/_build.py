"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` source goes through ONE ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds, not minutes).  The library lands in ``build/kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch (or -1 for
arguments it refuses); ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# dtype codes shared with csrc/common.cuh
F32, BF16, INT8, INT32 = 0, 1, 2, 3

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, x_dtype, size, q, s, n_blocks, stream
    "quant_int8_launch": [_P, _I, _LL, _P, _P, _LL, _P],
    # q, q_dtype, s, size, out, out_dtype, stream
    "dequant_int8_launch": [_P, _I, _P, _LL, _P, _I, _P],
    # x, x_dtype, size, amax, n_blocks, stream
    "amax_block_launch": [_P, _I, _LL, _P, _LL, _P],
    # x, x_dtype, size, s, q, n_blocks, stream
    "quant_scaled_launch": [_P, _I, _LL, _P, _P, _LL, _P],
    # q, k, v, o, dtype, B, H, K, Sq, Skv, dh,
    # 12 strides (b, h, s for q, k, v, o), scale, causal, window,
    # q_offset, valid_kv, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    + [_LL] * 12 + [_F, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library, with how long its build took."""

    def __init__(self, path: pathlib.Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build() -> tuple[pathlib.Path, float]:
    """Compile every source in one nvcc call unless the hashed library
    exists.  Returns (library path, seconds spent building)."""
    srcs = sources()
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


@functools.cache
def library() -> KernelLibrary:
    path, seconds = build()
    return KernelLibrary(path, seconds)


def check(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: arguments refused by the kernel")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
