"""Orchestrate the full dry-run matrix: 10 archs × 4 shapes × 2 meshes.

The twin of ``repro.launch.dryrun_all``.  Each combo runs
``repro_torch.launch.dryrun`` in a fresh child process (a process holds
one default process group; failures stay isolated) with a timeout.
Records are cached as JSON under ``results/dryrun_torch/`` (a failure as
``.err`` beside its record's name): re-running skips completed combos.
``benchmarks/roofline.py`` reads the JAX package's ``results/dryrun/``
and never these.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--only-single-pod]
      [--jobs N]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all --summary
      # the cached records as a markdown table
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")


def combo_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.abspath(os.path.join(
        RESULTS_DIR, f"{arch}__{shape}__{mesh}.json"))


def run_combo(arch: str, shape: str, multi_pod: bool,
              timeout_s: int = 1500) -> dict:
    mesh = "2x16x16" if multi_pod else "16x16"
    out = combo_path(arch, shape, mesh)
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd += ["--multi-pod", "--no-extrapolate"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "../.."))
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, env=env)
        ok = proc.returncode == 0 and os.path.exists(out)
        if not ok:
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": proc.stderr[-3000:], "elapsed_s":
                       time.time() - t0}
            with open(out + ".err", "w") as f:
                json.dump(rec, f, indent=2)
            return rec
        with open(out) as f:
            return json.load(f)
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": mesh,
               "error": f"timeout after {timeout_s}s"}
        with open(out + ".err", "w") as f:
            json.dump(rec, f, indent=2)
        return rec


def _reason(rec: dict) -> str:
    """An .err record's reason: its timeout, or the last line of the
    error it printed."""
    lines = [x for x in rec["error"].strip().splitlines() if x.strip()]
    return lines[-1][:160] if lines else "no output"


def _num(x: float) -> str:
    return f"{x:,.1f}" if x >= 10 else f"{x:.3g}"


def _cell(arch: str, shape: str) -> str:
    """One combo's figures: the three roofline terms (ms) and the
    dominant one, MODEL_FLOPS over the trace's FLOPs, argument and temp
    GiB, the trace's seconds; then the 2 x 16 x 16 combo's outcome."""
    gib = 1 << 30
    out = []
    for mesh in ("16x16", "2x16x16"):
        path = combo_path(arch, shape, mesh)
        if os.path.exists(path):
            with open(path) as f:
                r = json.load(f)
            t, m = r["roofline"], r["memory"]
            dom = t["dominant"].split("_")[0]
            if mesh == "16x16":
                out.append(" / ".join(_num(t[k] * 1e3) for k in (
                    "compute_s", "memory_s", "collective_s"))
                    + f" ms, {dom}; {r['useful_flops_ratio']:.3f}; "
                    f"{_num(m['argument_bytes'] / gib)} / "
                    f"{_num(m['temp_bytes'] / gib)} GiB; "
                    f"{r['trace_s']:.0f} s")
            else:
                out.append(f"2x16x16 {dom}, "
                           f"{_num(m['argument_bytes'] / gib)} GiB")
        elif os.path.exists(path + ".err"):
            with open(path + ".err") as f:
                out.append(f"{mesh} error: {_reason(json.load(f))}")
        else:
            out.append(f"{mesh} not run")
    return "; ".join(out)


def summary() -> str:
    """The cached records as markdown, a row an arch and a column a
    shape (``_cell``)."""
    rows = ["| arch (a trace of the gather-at-entry model) | "
            + " | ".join(INPUT_SHAPES) + " |",
            "|---|" + "---|" * len(INPUT_SHAPES)]
    for arch in ASSIGNED_ARCHS:
        rows.append(f"| {arch} | " + " | ".join(
            _cell(arch, shape) for shape in INPUT_SHAPES) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--summary", action="store_true",
                    help="print the cached records as a table and exit")
    ap.add_argument("--only-single-pod", action="store_true")
    ap.add_argument("--only-multi-pod", action="store_true")
    ap.add_argument("--timeout", type=int, default=1500)
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos run at once, each in its own process")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary())
        return 0
    os.makedirs(RESULTS_DIR, exist_ok=True)
    meshes = []
    if not args.only_multi_pod:
        meshes.append(False)
    if not args.only_single_pod:
        meshes.append(True)
    combos = [(arch, shape, multi_pod) for multi_pod in meshes
              for arch in ASSIGNED_ARCHS for shape in INPUT_SHAPES]
    # the longest traces first, so that they overlap: a Mamba mixer's
    # plain scan is a Python loop over the sequence's positions, and its
    # train and prefill combos run into the timeout (an .err record)
    combos.sort(key=lambda c: not (get_config(c[0]).mamba is not None
                                   and INPUT_SHAPES[c[1]].kind != "decode"))
    t0 = time.time()

    def one(combo):
        arch, shape, multi_pod = combo
        rec = run_combo(arch, shape, multi_pod, args.timeout)
        status = "ERR " if "error" in rec else "ok  "
        print(f"[{time.time() - t0:7.0f}s] {status} {arch:24s} "
              f"{shape:12s} {'2x16x16' if multi_pod else '16x16'}",
              flush=True)
        return "error" not in rec

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        ok = sum(pool.map(one, combos))
    print(f"done: {ok}/{len(combos)} combos succeeded")
    return 0 if ok == len(combos) else 1


if __name__ == "__main__":
    sys.exit(main())
