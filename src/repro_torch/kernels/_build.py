"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so the build takes
seconds, not minutes).  The library lands in ``build/kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch (or -1 for
arguments it refuses); ``check`` raises on anything but 0.

A wrapper given a tensor with no data (``shape_only``: a fake tensor of
``FakeTensorMode``, or a meta tensor) returns outputs of the shapes,
dtypes and strides its launch would write, loads no library, reads no
address, and counts the call in ``.fake_launches`` (``count_shape_only``)
beside its ``.launches``.  That is how the dry run traces the card's path
without a card; a tensor with data never takes that branch.
"""

from __future__ import annotations

import contextlib
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
from torch._subclasses.fake_tensor import is_fake

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

# dtype codes shared with csrc/common.cuh
F32, BF16, INT8, INT32 = 0, 1, 2, 3

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, x_dtype, size, q, s, n_blocks, stream
    "quant_int8_launch": [_P, _I, _LL, _P, _P, _LL, _P],
    # q, q_dtype, s, size, out, out_dtype, vector, stream
    "dequant_int8_launch": [_P, _I, _P, _LL, _P, _I, _I, _P],
    # x, x_dtype, size, amax, n_blocks, vector, stream
    "amax_block_launch": [_P, _I, _LL, _P, _LL, _I, _P],
    # x, x_dtype, size, s, q, n_blocks, vector, stream
    "quant_scaled_launch": [_P, _I, _LL, _P, _P, _LL, _I, _P],
    # q, k, v, o, dtype, B, H, K, Sq, Skv, dh,
    # 12 strides (b, h, s for q, k, v, o), scale, causal, window,
    # q_offset, valid_kv, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    + [_LL] * 12 + [_F, _I, _I, _I, _I, _P],
    # spans, n_spans, n_tiles, buf, buf_dtype, stream
    "pack_slots_launch": [_P, _I, _LL, _LL, _P, _I, _P],
    # spans, n_spans, n_blocks, q, s, stream
    "fused_pack_quant_launch": [_P, _I, _LL, _P, _P, _P],
    # x, dt, A, B, C, dtype, y, states, batch, S, H, G, P, N, Q,
    # 12 strides (b, s, h|g for x, dt, B, C), heads_per_block, stream
    "ssd_chunk_launch": [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 7
    + [_LL] * 12 + [_I, _P],
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of each that
    failed, once every one has ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> tuple[pathlib.Path, float]:
    """Compile every source (one nvcc process each, in parallel) and link
    them, unless the hashed library exists.  Returns (library path,
    seconds spent building)."""
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{src.stem}.o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for obj, src in zip(objs, sources())])
        lib = str(pathlib.Path(tmp) / "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)   # atomic: a concurrent loader never sees half a file
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


class NoBackwardError(RuntimeError):
    """A forward-only kernel was called where autograd would differentiate
    its output."""


def refuse_autograd(what: str, *tensors) -> None:
    """Raise ``NoBackwardError`` when autograd records and an input
    requires grad: the kernel writes fresh tensors with no ``grad_fn``, so
    the gradients to its inputs would silently be zero."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{what}: the kernel has no backward, and an input requires grad; run it "
            f"under torch.no_grad() or inference_mode, or differentiate the plain version")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data to launch on: a fake tensor
    (``FakeTensorMode``) or a meta tensor."""
    return t.device.type == "meta" or is_fake(t)


# callbacks of the dry run's recorder: each shape-only call is reported
_SHAPE_ONLY_LISTENERS: list = []


def count_shape_only(wrapper, name: str, **info) -> None:
    """Count a shape-only call of ``wrapper`` (its ``.fake_launches``) and
    report it, with ``info`` (its tensors and arguments), to every
    listener of ``shape_only_calls``."""
    wrapper.fake_launches += 1
    for listener in _SHAPE_ONLY_LISTENERS:
        listener(name, info)


@contextlib.contextmanager
def shape_only_calls(listener):
    """Call ``listener(name, info)`` for every shape-only kernel call
    inside the block."""
    _SHAPE_ONLY_LISTENERS.append(listener)
    try:
        yield
    finally:
        _SHAPE_ONLY_LISTENERS.remove(listener)
