"""Per-CTA phase stamps in a copy of one of the port's CUDA kernels, for
the scripts that split a launch's time into phases on the card
(``flash_prefill_phases.py``, ``latent_phases.py``).

A script names, per source file of ``src/repro_torch/kernels/csrc``, the
(anchor, replacement) edits that read ``now_ns()`` (``%globaltimer``) at
the kernel's phase boundaries and store the results in
``g_stamp[cta][i]``.  ``build`` copies the sources into a directory under
``build/phases/`` (the library the port loads is not touched), declares
``g_stamp`` and ``now_ns()`` ahead of the kernel's namespace, adds
``phase_stamps`` (copy ``g_stamp`` to the host) and ``phase_stamps_clear``
to the library's C interface, applies the edits, builds the library with
the port's ``nvcc`` flags and loads it.  Each anchor must appear exactly
once in its file, or the build stops and names it: a kernel edited since
the script was written must not be measured as something else.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def build(cu: str, patches: dict, *, namespace: str, n_ctas: int,
          n_stamps: int, subdir: str) -> ctypes.CDLL:
    """Build ``cu`` (a file of ``csrc``) with ``patches`` ({file name:
    [(anchor, replacement), ...]}) applied; the stamps are declared in the
    first file ``patches`` names, ahead of its ``namespace``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    out = ROOT / "build" / "phases" / subdir
    out.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    decl = (f"__device__ unsigned long long g_stamp[{n_ctas}][{n_stamps}];\n"
            "__device__ __forceinline__ unsigned long long now_ns() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n\n")
    readers = (
        "int phase_stamps(void* host) {\n"
        "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n"
        "}\n\nint phase_stamps_clear() {\n"
        f"  static unsigned long long zero[{n_ctas}][{n_stamps}];\n"
        "  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));\n"
        "}\n\n")
    edits = {name: list(es) for name, es in patches.items()}
    ns = f"namespace {namespace} {{\n"
    edits[next(iter(patches))].insert(0, (ns, decl + ns))
    edits.setdefault(cu, []).append(('}  // extern "C"',
                                     readers + '}  // extern "C"'))
    for name, es in edits.items():
        src = files[name]
        for anchor, text in es:
            if src.count(anchor) != 1:
                raise SystemExit(f"{name}: anchor found {src.count(anchor)} "
                                 f"times, not once: {anchor!r}")
            src = src.replace(anchor, text)
        files[name] = src
    for name, src in files.items():
        (out / name).write_text(src)
    lib_path = out / f"lib{Path(cu).stem}_stamped.so"
    done = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o",
                           str(lib_path), str(out / cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on the stamped {cu}:\n{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.phase_stamps.argtypes = [ctypes.c_void_p]
    lib.n_stamps = (n_ctas, n_stamps)
    return lib


def read(lib) -> np.ndarray:
    """The library's (n_ctas, n_stamps) stamps."""
    stamps = np.zeros(lib.n_stamps, np.uint64)
    if lib.phase_stamps(stamps.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    return stamps


def clear(lib) -> None:
    if lib.phase_stamps_clear():
        raise RuntimeError("clearing the stamps failed")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
