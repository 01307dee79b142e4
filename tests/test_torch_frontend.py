"""The port's streaming HTTP front end (``repro_torch.serving.frontend``)
against ``repro.serving.frontend``, on the CPU.

Each package serves a 2-instance fleet of the drop-free smoke
``qwen2-moe-a2.7b`` (``test_torch_fleet_cases``: pinned virtual costs,
one shared ``weights.npz``, collocated) behind its own
``ServingFrontend`` on port 0, its event loop on a thread of its own.
Both get the same exchanges, in the same order: ``/health``, a plain
completion (a token-id prompt, then a string prompt), a streamed one
through a ``fail_device`` sent mid-stream, ``/health`` and
``/instances``, ``planned_restart`` until healthy, and every 400, 404,
405 and 413 case.  The tokens, ``usage``, ``finish_reason``, status
codes, health and the arbiter's decisions must equal the reference's;
the ``id``s and the wall-clock fields (recovery seconds, straggler
signals, host gap) are left out.

A command that raises (``/control`` on an unknown instance or op) never
answers in ``repro``: its ``_call`` sets the exception from a callback
that reads the ``except`` block's name after the block has ended
(``NameError`` on the event loop), so the client waits for its timeout.
The port answers 400.  ``_repair_reference_call`` gives the reference
instance the port's ``_call`` shape before comparing (ROADMAP Queue 3;
nothing in ``repro`` changes).

The fault must land on the same engine step in both packages, so the
streamed exchange steps the fleet tick by tick: the test holds each tick
at a gate until the fault's command is queued (the reference's driver
holds its lock across a tick; its gate lets the lock go while it waits).
"""
import asyncio
import http.client
import json
import re
import socket
import threading
import time

import pytest

import repro.serving.frontend as jax_frontend
import repro_torch.serving.frontend as torch_frontend
from test_torch_fleet_cases import (JAX, PROMPT, SIDES, TORCH, fleet_cfg,
                                    fleet_ecfg, make_dirs, profile)

FRONTENDS = {JAX.name: jax_frontend, TORCH.name: torch_frontend}
TIMEOUT_S = 120
MAX_TOKENS = 12
FAULT_AFTER = 4        # tokens committed before the fault's command
FAULT_PID = 0          # the rank the stream's request decodes on
SMALL_PROMPT = [int(t) for t in PROMPT]

# the error cases: (raw request, expected status)
ERRORS = {
    "bad_json": (b"POST /v1/completions HTTP/1.1\r\nContent-Length: 5\r\n"
                 b"\r\n{oops", 400),
    "empty_prompt": ("/v1/completions", {"prompt": ""}, 400),
    "prompt_type": ("/v1/completions", {"prompt": [1, "x"]}, 400),
    "token_out_of_range": ("/v1/completions", {"prompt": [1, 10 ** 9]},
                           400),
    "max_tokens_zero": ("/v1/completions",
                        {"prompt": [1, 2], "max_tokens": 0}, 400),
    "control_no_op": ("/control", {"iid": 0}, 400),
    "control_bad_iid": ("/control", {"op": "drain_instance", "iid": 7},
                        400),
    "control_unknown_op": ("/control", {"op": "reboot", "iid": 0}, 400),
    "malformed_request_line": (b"GARBAGE\r\n\r\n", 400),
    "no_route": (b"GET /v2/chat HTTP/1.1\r\n\r\n", 404),
    "completions_get": (b"GET /v1/completions HTTP/1.1\r\n\r\n", 405),
    "control_get": (b"GET /control HTTP/1.1\r\n\r\n", 405),
    "body_too_large": (b"POST /v1/completions HTTP/1.1\r\n"
                       b"Content-Length: 2000000\r\n\r\n", 413),
}


class Gate:
    """Holds each of the router's ticks until the test lets one through
    (while ``manual``); free-running otherwise.  ``held_lock``: a lock
    the driver holds across a tick, let go while the tick waits."""

    def __init__(self, router, held_lock=None):
        self.sem = threading.Semaphore(0)
        self.manual = False
        self.waiting = False
        self.done = 0
        self.held_lock = held_lock
        real = router.tick

        def tick():
            if self.manual:
                if self.held_lock is not None:
                    self.held_lock.release()
                self.waiting = True
                try:
                    assert self.sem.acquire(timeout=TIMEOUT_S), "gate stuck"
                finally:
                    self.waiting = False
                    if self.held_lock is not None:
                        self.held_lock.acquire()
            out = real()
            self.done += 1
            return out

        router.tick = tick

    def wait_held(self):
        _until(lambda: self.waiting, "the driver to reach the gate")

    def step(self):
        """Let one tick through and wait until it has run."""
        self.wait_held()
        n = self.done
        self.sem.release()
        _until(lambda: self.done > n, "a tick")

    def free(self):
        self.manual = False
        self.sem.release()


def _until(cond, what):
    deadline = time.time() + TIMEOUT_S
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


class Server:
    """A ServingFrontend on its own thread and event loop."""

    def __init__(self, module, router):
        self.fe = module.ServingFrontend(router, port=0)
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def main():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.fe.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=main, daemon=True)
        self.thread.start()
        assert started.wait(TIMEOUT_S)
        self.port = self.fe.port

    def close(self):
        asyncio.run_coroutine_threadsafe(self.fe.stop(),
                                         self.loop).result(TIMEOUT_S)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT_S)
        assert not self.thread.is_alive()


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def raw_request(port, data: bytes):
    """Send ``data`` as is; returns (status, JSON body)."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT_S) as sock:
        sock.sendall(data)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            assert chunk, buf
            buf += chunk
        head, body = buf.split(b"\r\n\r\n", 1)
        status = int(head.split(b" ")[1])
        length = int(re.search(rb"Content-Length: (\d+)", head).group(1))
        while len(body) < length:
            body += sock.recv(65536)
        return status, json.loads(body)


def stream(port, spec, events):
    """POST a streamed completion; append each SSE event's JSON (the
    terminal ``[DONE]`` as None) to ``events``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps(dict(spec, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        events.append(resp.status)
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                ev, buf = buf.split(b"\n\n", 1)
                payload = ev[len(b"data: "):]
                events.append(None if payload == b"[DONE]"
                              else json.loads(payload))
    finally:
        conn.close()


def _repair_reference_call(fe):
    """``repro``'s ``ServingFrontend._call`` with the exception bound
    when the callback is made (see the module docstring)."""
    def _call(fn):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def run():
            try:
                res = fn()
            except Exception as e:
                loop.call_soon_threadsafe(
                    lambda e=e: fut.cancelled() or fut.set_exception(e))
            else:
                loop.call_soon_threadsafe(
                    lambda: fut.cancelled() or fut.set_result(res))

        with fe._lock:
            fe._commands.append(run)
        return fut

    fe._call = _call


def _strip_health(h):
    for inst in h["instances"].values():
        inst.pop("soft_signals", None)      # wall-clock based
    return h


def _strip_instances(info):
    for row in info["instances"]:
        row.pop("host_gap_fraction", None)  # wall-clock based
        # a recovery's scenario, mode and counts, without its seconds
        row["recoveries"] = [re.sub(r" total=\S+| :: .*", "", r)
                             for r in row.get("recoveries", [])]
    return info


def exchanges(S, wd):
    """Every exchange of the module, in order, on one package's fleet and
    front end.  Returns {exchange: what the client saw}."""
    fleet = S.fleet.build_fleet(
        fleet_cfg(S), fleet_ecfg(S, wd, mode="collocated"), instances=2,
        cost_profile=profile(S), **S.kw)
    srv = Server(FRONTENDS[S.name], fleet)
    if S is JAX:
        _repair_reference_call(srv.fe)
    gate = Gate(fleet, srv.fe._lock if S is JAX else None)
    port, out = srv.port, {}
    try:
        out["health_before"] = request(port, "GET", "/health")
        for name, prompt in (("ids", SMALL_PROMPT),
                             ("string", "revive in place")):
            out[f"plain_{name}"] = request(port, "POST", "/v1/completions", {
                "prompt": prompt, "max_tokens": 6, "eos_token": None})
        # the streamed completion, a device fault sent mid-stream
        gate.manual = True
        events = []
        n0 = len(fleet.requests)
        reader = threading.Thread(target=stream, args=(port, {
            "prompt": SMALL_PROMPT, "max_tokens": MAX_TOKENS,
            "eos_token": None}, events))
        reader.start()
        _until(lambda: len(fleet.requests) > n0, "the stream's submit")
        req = fleet.requests[-1]
        while len(req.committed_output) < FAULT_AFTER:
            gate.step()
        gate.wait_held()
        control = {}
        sender = threading.Thread(target=lambda: control.update(
            res=request(port, "POST", "/control",
                        {"op": "fail_device", "iid": req.instance_id,
                         "pid": FAULT_PID})))
        sender.start()
        _until(lambda: srv.fe._commands, "the fault's command")
        gate.step()
        sender.join(TIMEOUT_S)
        gate.free()
        reader.join(TIMEOUT_S)
        assert not reader.is_alive() and not sender.is_alive()
        out["fault"] = control["res"]
        out["stream"] = events
        out["stream_instance"] = req.instance_id
        out["health_degraded"] = request(port, "GET", "/health")
        out["instances"] = request(port, "GET", "/instances")
        out["restart"] = request(port, "POST", "/control", {
            "op": "planned_restart", "iid": req.instance_id})
        deadline = time.time() + TIMEOUT_S
        while True:
            health = request(port, "GET", "/health")
            if health[1]["state"] == "healthy" or time.time() > deadline:
                break
            time.sleep(0.01)
        out["health_after"] = health
        out["instances_after"] = request(port, "GET", "/instances")
        for name, case in ERRORS.items():
            if isinstance(case[0], bytes):
                out[name] = raw_request(port, case[0])
            else:
                out[name] = request(port, "POST", case[0], case[1])
    finally:
        gate.free()
        srv.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dirs = make_dirs(tmp_path_factory, "frontend")
    return {S.name: exchanges(S, dirs[S.name]) for S in SIDES}


def _pair(runs, key):
    return runs[JAX.name][key], runs[TORCH.name][key]


@pytest.mark.parametrize("name", ["ids", "string"])
def test_plain_completion_equals_repro(runs, name):
    (js, jb), (ps, pb) = _pair(runs, f"plain_{name}")
    assert ps == js == 200
    assert pb["object"] == "text_completion"
    assert pb["id"].startswith("cmpl-")
    for body in (pb, jb):
        body.pop("id")
    assert pb == jb
    assert len(pb["choices"][0]["tokens"]) == 6
    assert pb["choices"][0]["finish_reason"] == "length"
    assert pb["usage"]["completion_tokens"] == 6


def test_stream_through_fault_equals_repro(runs):
    """Status, SSE framing, every token chunk and the finish reason."""
    jev, pev = _pair(runs, "stream")
    assert pev[0] == jev[0] == 200
    assert pev[-1] is None and jev[-1] is None          # data: [DONE]
    for ev in pev[1:-1] + jev[1:-1]:
        assert ev.pop("id").startswith("cmpl-")
        assert ev["object"] == "text_completion.chunk"
    assert pev == jev
    tokens = [t for ev in pev[1:-1] for t in ev["choices"][0]["tokens"]]
    assert len(tokens) == MAX_TOKENS
    assert pev[-2]["choices"][0]["finish_reason"] == "length"
    assert all(ev["choices"][0]["finish_reason"] is None
               for ev in pev[1:-2])


def test_fault_control_equals_repro(runs):
    (js, jb), (ps, pb) = _pair(runs, "fault")
    assert ps == js == 200
    assert pb == jb == {"ok": True, "op": "fail_device",
                        "iid": runs[TORCH.name]["stream_instance"],
                        "pid": FAULT_PID}


@pytest.mark.parametrize("key", ["health_before", "health_degraded",
                                 "health_after"])
def test_health_equals_repro(runs, key):
    (js, jb), (ps, pb) = _pair(runs, key)
    assert ps == js == 200
    assert _strip_health(pb) == _strip_health(jb)
    want = {"health_before": "healthy", "health_degraded": "degraded",
            "health_after": "healthy"}[key]
    assert pb["state"] == want


@pytest.mark.parametrize("key", ["instances", "instances_after"])
def test_instances_and_decisions_equal_repro(runs, key):
    (js, jb), (ps, pb) = _pair(runs, key)
    assert ps == js == 200
    assert _strip_instances(pb) == _strip_instances(jb)
    revives = [d for d in pb["decisions"]
               if d["decision"]["policy"] == "revive"]
    assert revives and "est_cost_s" in revives[0]["decision"]
    target = runs[TORCH.name]["stream_instance"]
    row = next(r for r in pb["instances"] if r["iid"] == target)
    assert len(row["recoveries"]) == 1     # full_reinit keeps the reports


def test_planned_restart_equals_repro(runs):
    (js, jb), (ps, pb) = _pair(runs, "restart")
    assert ps == js == 200 and pb == jb
    assert pb["op"] == "planned_restart"
    row = next(r for r in runs[TORCH.name]["instances_after"][1]["instances"]
               if r["iid"] == pb["iid"])
    assert row["restarts"] == 1


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_status_equals_repro(runs, case):
    (js, jb), (ps, pb) = _pair(runs, case)
    assert ps == js == ERRORS[case][-1]
    assert pb == jb and "error" in pb


# -- the port's own behaviour ---------------------------------------------------

def test_failed_tick_ends_open_streams_with_error(tmp_path):
    """A tick that raises ends the open stream with finish_reason
    "error", answers later requests with 503 and wakes the launcher's
    wait; the reference's driver thread dies there instead."""
    S = TORCH
    wd = tmp_path / "torch"
    wd.mkdir()
    fleet = S.fleet.build_fleet(
        fleet_cfg(S), fleet_ecfg(S, wd, mode="collocated"), instances=1,
        cost_profile=profile(S), **S.kw)
    real, ticks = fleet.tick, []

    def tick():
        ticks.append(1)
        if len(ticks) == 3:
            raise RuntimeError("device lost")
        return real()

    fleet.tick = tick
    srv = Server(torch_frontend, fleet)
    try:
        events = []
        stream(srv.port, {"prompt": SMALL_PROMPT, "max_tokens": 20}, events)
        assert events[0] == 200 and events[-1] is None
        assert events[-2]["choices"][0]["finish_reason"] == "error"
        got = [t for ev in events[1:-1] for t in ev["choices"][0]["tokens"]]
        assert len(got) < 20
        assert isinstance(srv.fe.failure, RuntimeError)
        status, body = request(srv.port, "GET", "/health")
        assert status == 503 and "device lost" in body["error"]
        failed = asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(srv.fe.wait_failed(), TIMEOUT_S), srv.loop)
        assert failed.result(TIMEOUT_S) is srv.fe.failure
    finally:
        srv.close()
