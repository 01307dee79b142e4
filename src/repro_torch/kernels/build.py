"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` — no
PyTorch headers, so one file builds in seconds.  Libraries land in
``build/kernels/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``),
named by a hash of their source, every ``csrc/*.cuh`` header and the
flags, so an edited kernel or header rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the
first launch builds, or :func:`build_all` builds every kernel at once,
one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("paged_attention", "moe_fused", "router_topk",
           "decode_megastep", "expert_ffn", "flash_prefill", "ssm_scan",
           "flash_prefill_bwd", "expert_ffn_bwd", "ssm_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_SMEM_BYTES = 232_448          # per block on an H100, after opt-in
# the ``dtype`` argument of every kernel's C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by several sources
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    (out.parent / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel in parallel; returns each ``nvcc`` log
    (``-Xptxas -v`` register and shared-memory report), empty for a
    library that was already built."""
    names = list(names)
    started = {n: _start(n) for n in names}
    logs = {}
    for n in names:
        logs[n] = "" if started[n] is None else _finish(n, started[n])
    return logs


def load(name: str, prototypes: Dict[str, Tuple[list, Any]]
         ) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use), with
    ``prototypes`` ({function: (argtypes, restype)}) applied — every
    pointer and the stream as ``c_void_p``, so ctypes never cuts one to
    32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in prototypes.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def refuse_grad(name: str, *tensors, hint: str = "") -> None:
    """A launcher's first check: under grad mode, a floating input that
    requires grad raises, since the output a launcher allocates carries
    no autograd history and would drop the gradient without an error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and "
            + (hint or "the kernel's backward is not ported")
            + "; call it under torch.no_grad() or on tensors that need "
            "no gradient")


def check_arg(name: str, t, dtype, shape, device) -> None:
    """A launcher's input check: raise on what the kernel does not take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
