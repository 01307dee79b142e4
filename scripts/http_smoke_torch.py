"""The HTTP front end's drill, against the port's launcher.

Boots a 2-instance fleet behind ``python -m repro_torch.launch.serve
--http`` (collocated, 2 DP ranks, the overlap pipeline on), streams one
completion over SSE, injects a device fault on the instance serving it
mid-stream, and asserts what ``scripts/http_smoke.py`` asserts of
``repro``'s launcher:

* the stream completes with every requested token and
  ``finish_reason: "length"`` (the revive keeps the position-seeded
  stream going through the fault);
* ``/instances`` shows the arbiter's revive decision with its
  counterfactual cost table (``est_cost_s``);
* ``/health`` reads degraded, then healthy after a planned restart
  through ``/control``.

On earlier lines it prints what a client feels: seconds to boot, time to
first token over HTTP, the largest gap between SSE chunks (the stall the
client sees across the revive), the revive's Table-1 seconds from
``/instances``, and seconds from the planned restart until ``/health``
reads healthy; on its last line those numbers as one JSON object.  On a
failure it prints the server's log and exits non-zero.

Run on the card: ``python scripts/http_smoke_torch.py --config full
--layers 8``; on the CPU: ``python scripts/http_smoke_torch.py --device
cpu --force-policy revive``.  The arbiter prices a restart from the
instance's measured start-up: a smoke engine of the port starts in
well under a second on the CPU, so there it rightly restarts, and the
drill of the revive path pins the policy (``--force-policy``, passed to
the launcher).  At full width on the card a start-up reads gigabytes of
weights, and the arbiter picks the revive on its own.
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BOOT_TIMEOUT_S = 600      # two full-width engine builds on a cold host
STREAM_TIMEOUT_S = 600
HEALTH_TIMEOUT_S = 300
REQUEST_TIMEOUT_S = 120
MAX_TOKENS = 48
FAULT_AFTER = 6           # tokens streamed before the fault


def launcher_cmd(args) -> list:
    """The launcher's command line: the drill's fleet, then the options
    passed through."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--fleet", "2",
           "--mode", "collocated", "--num-dp", "2", "--overlap",
           "--http", "0", "--device", args.device, "--config", args.config,
           "--workdir", args.workdir]
    if args.dtype is not None:
        cmd += ["--dtype", args.dtype]
    if args.layers is not None:
        cmd += ["--layers", str(args.layers)]
    if args.force_policy is not None:
        cmd += ["--force-policy", args.force_policy]
    return cmd


def boot(args):
    """Start the launcher; returns (process, its output lines: a list
    that a reader thread extends)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(launcher_cmd(args), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(ROOT))
    lines: list = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    return proc, lines


def stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def wait_for_port(proc, lines) -> int:
    """Scrape the bound port off the launcher's banner line."""
    deadline = time.time() + BOOT_TIMEOUT_S
    while time.time() < deadline:
        for ln in list(lines):
            m = re.search(r"serving on http://[\d.]+:(\d+)", ln)
            if m:
                return int(m.group(1))
        if proc.poll() is not None:
            raise AssertionError(f"server exited early ({proc.returncode})")
        time.sleep(0.25)
    raise AssertionError("timed out waiting for the server banner")


def get_json(port, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=REQUEST_TIMEOUT_S)
    try:
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200, (path, resp.status, data[:300])
        return json.loads(data)
    finally:
        conn.close()


def loaded_instance(port):
    info = get_json(port, "/instances")
    for row in info["instances"]:
        if row["state"] != "dead" and row.get("load", 0) > 0:
            return row["iid"]
    raise AssertionError(f"no loaded instance: {info['instances']}")


def stream_through_fault(port):
    """Stream one completion, failing a device of its instance after
    FAULT_AFTER tokens.  Returns (tokens, finish_reason, the instance,
    the seconds to the first token, each token chunk's arrival time)."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=STREAM_TIMEOUT_S)
    t_send = time.perf_counter()
    conn.request("POST", "/v1/completions", body=json.dumps({
        "prompt": [5, 9, 2, 7] * 3, "max_tokens": MAX_TOKENS,
        "stream": True, "eos_token": None,
    }), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    tokens: list = []
    arrivals: list = []
    finish_reason = None
    target = None
    buf = b""
    while finish_reason is None:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            ev, buf = buf.split(b"\n\n", 1)
            if not ev.startswith(b"data: "):
                continue
            payload = ev[len(b"data: "):]
            if payload == b"[DONE]":
                buf = b""
                break
            choice = json.loads(payload)["choices"][0]
            if choice["tokens"]:
                arrivals.append(time.perf_counter())
                tokens.extend(choice["tokens"])
            if choice["finish_reason"] is not None:
                finish_reason = choice["finish_reason"]
        if target is None and len(tokens) >= FAULT_AFTER:
            # mid-stream: fail a device on the instance serving us
            target = loaded_instance(port)
            res = get_json(port, "/control", method="POST",
                           body={"op": "fail_device", "iid": target})
            print(f"injected device fault on instance {target}: {res}",
                  flush=True)
    conn.close()
    assert target is not None, "stream finished before the fault"
    return tokens, finish_reason, target, arrivals[0] - t_send, arrivals


def drill(port) -> dict:
    """The drill's steps and asserts; returns the client's numbers."""
    health = get_json(port, "/health")
    assert health["state"] == "healthy", health
    assert health["serving"] == 2, health

    tokens, finish_reason, target, ttft, arrivals = \
        stream_through_fault(port)
    assert len(tokens) == MAX_TOKENS, (len(tokens), MAX_TOKENS)
    assert finish_reason == "length", finish_reason
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    print(f"stream completed through the fault: {len(tokens)} tokens, "
          f"finish_reason={finish_reason}", flush=True)

    # the arbiter's decision must be visible with its cost table
    info = get_json(port, "/instances")
    revives = [d for d in info["decisions"]
               if d.get("decision", {}).get("policy") == "revive"]
    assert revives, f"no revive decision recorded: {info['decisions']}"
    assert "est_cost_s" in revives[0]["decision"], revives[0]
    print(f"arbiter decision: {revives[0]['decision']}", flush=True)
    row = next(r for r in info["instances"] if r["iid"] == target)
    assert row["recoveries"], row
    revive_s = float(re.search(r"total=([\d.]+)s",
                               row["recoveries"][0]).group(1))

    # the revived instance serves degraded until a planned restart
    health = get_json(port, "/health")
    inst = health["instances"][str(target)]
    assert inst["degraded"], inst
    assert health["state"] == "degraded", health["state"]
    print(f"health degraded as expected: instance {target} "
          f"healthy_dp={inst['healthy_dp']}/{inst['total_dp']} "
          f"masked={inst['masked_expert_fraction']:.3f}", flush=True)

    t_restart = time.perf_counter()
    get_json(port, "/control", method="POST",
             body={"op": "planned_restart", "iid": target})
    deadline = time.time() + HEALTH_TIMEOUT_S
    while time.time() < deadline:
        health = get_json(port, "/health")
        inst = health["instances"][str(target)]
        if health["state"] == "healthy" and not inst["degraded"]:
            break
        time.sleep(0.25)
    restart_s = time.perf_counter() - t_restart
    assert health["state"] == "healthy", health
    assert not inst["degraded"], inst
    print("fleet healthy again after planned restart", flush=True)
    return dict(ttft_s=ttft, max_sse_gap_s=max(gaps),
                revive_s=revive_s, restart_to_healthy_s=restart_s,
                tokens=len(tokens), recovery=row["recoveries"][0])


def run(args) -> dict:
    """Boot the launcher, run the drill, stop the launcher (also on a
    failure, after printing its log).  Returns the client's numbers."""
    t0 = time.perf_counter()
    proc, lines = boot(args)
    try:
        port = wait_for_port(proc, lines)
        boot_s = time.perf_counter() - t0
        print(f"server up on :{port} in {boot_s:.1f} s", flush=True)
        numbers = dict(boot_s=boot_s, **drill(port))
    except BaseException:
        print("server log:\n" + "".join(lines), flush=True)
        raise
    finally:
        stop(proc)
    for key in ("boot_s", "ttft_s", "max_sse_gap_s", "revive_s",
                "restart_to_healthy_s"):
        print(f"client: {key} {numbers[key]:.4f}", flush=True)
    return numbers


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None,
                    choices=[None, "bfloat16", "float32"])
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--force-policy", default=None,
                    choices=[None, "revive", "restart", "spare"],
                    help="pin the launcher's recovery arbiter")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "http_smoke_torch"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    numbers = run(parse_args(argv))
    print("HTTP smoke OK", flush=True)
    print(json.dumps(numbers), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
