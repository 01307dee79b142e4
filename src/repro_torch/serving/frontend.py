"""Streaming HTTP serving front end over the fleet router.

A deliberately dependency-free asyncio server (hand-rolled HTTP/1.1 +
server-sent events — the container has no web framework) that turns the
in-process :class:`~repro_torch.fleet.router.FleetRouter` into something a
client can actually talk to:

* ``POST /v1/completions`` — OpenAI-style completions.  ``prompt`` is a
  list of token ids (or a string, byte-encoded mod vocab — the repro
  models have no tokenizer).  ``"stream": true`` switches the response
  to SSE chunks, one per committed token batch.
* ``GET  /health``     — fleet health + per-instance ``InstanceHealth``,
  including each instance's masked-expert fraction (degraded quality
  surface while a revive serves with experts masked).
* ``GET  /instances``  — instance detail + every arbiter decision so
  far (revive vs restart vs spare, with the counterfactual cost table).
* ``POST /control``    — fault-injection ops for drills and CI smoke:
  ``fail_device`` / ``lose_instance`` / ``drain_instance`` /
  ``planned_restart``.

Threading model: the fleet ticks on a dedicated driver thread (kernel
launches + host planning must not block the event loop); the asyncio
side talks to it through a command queue, and token progress flows back
through per-request ``asyncio.Queue`` handoffs scheduled with
``call_soon_threadsafe``.  Streams only ever see
``Request.committed_output`` — the overlap pipeline's speculative
guesses never reach a client.

This is ``repro.serving.frontend`` with its imports renamed, and four
differences, the first three of which running on the card asks for:

* PyTorch's grad mode, current device and current stream are each
  thread's own.  The driver thread takes the ones of the thread that
  built the front end, so a tick there launches on the stream (and
  leaves the state) a tick on that thread would.
* The command queue has a lock of its own, held for an append or a
  swap: an HTTP handler never waits for a tick, so ``/health`` answers
  while a full-width step (or a restart's reload) runs.
* A tick that raises ends every open stream with ``finish_reason:
  "error"``, fails the queued commands, answers later requests with 503,
  and makes :func:`serve_http` return the exception (the launcher then
  exits non-zero).  The reference's driver thread dies there and its
  open streams hang until the client gives up.
* A command that raises (a ``/control`` op on an unknown instance)
  answers 400.  The reference's callback reads the exception after its
  ``except`` block has ended, so that request never answers.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.request import Request, RequestState

_MAX_BODY = 1 << 20          # 1 MiB request-body bound
_IDLE_SLEEP_S = 0.004        # driver poll period when the fleet is idle
_STOP_TIMEOUT_S = 10.0       # the wait for open connections at exit


def _encode_prompt(prompt, vocab_size: int) -> List[int]:
    """Token-id lists pass through; strings byte-encode mod vocab (the
    smoke models are tokenizer-free, determinism is what matters)."""
    if isinstance(prompt, str):
        if not prompt:
            raise ValueError("prompt must be non-empty")
        return [b % vocab_size for b in prompt.encode("utf-8")]
    if (isinstance(prompt, list) and prompt
            and all(isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt)):
        bad = [t for t in prompt if not 0 <= t < vocab_size]
        if bad:
            raise ValueError(
                f"prompt token ids out of range [0, {vocab_size}): "
                f"{bad[:4]}")
        return list(prompt)
    raise ValueError("prompt must be a string or a non-empty list of "
                     "token ids")


class DriverFailed(RuntimeError):
    """The fleet driver's tick raised: the front end serves no more."""


class _Stream:
    """Bridge from the driver thread to one HTTP response: the driver
    pushes committed-token batches, the handler awaits them."""

    def __init__(self, req: Request, loop: asyncio.AbstractEventLoop):
        self.req = req
        self.loop = loop
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.sent = 0            # committed tokens already published
        self.failed = False      # ended by a driver failure

    def fail(self) -> None:
        """Driver side, after its tick raised: end the stream."""
        self.failed = True
        self.loop.call_soon_threadsafe(self.queue.put_nowait, None)

    def publish(self) -> bool:
        """Driver side: push any newly committed tokens; True when the
        request reached a terminal state (stream complete)."""
        committed = self.req.committed_output
        if len(committed) > self.sent:
            new = list(committed[self.sent:])
            self.sent = len(committed)
            self.loop.call_soon_threadsafe(self.queue.put_nowait, new)
        if self.req.state in (RequestState.FINISHED, RequestState.FAILED):
            self.loop.call_soon_threadsafe(self.queue.put_nowait, None)
            return True
        return False


class ServingFrontend:
    """Asyncio HTTP server + fleet driver thread over a FleetRouter."""

    def __init__(self, router, *, host: str = "127.0.0.1",
                 port: int = 8077):
        self.router = router
        self.host = host
        self.port = port
        # the router and every engine under it are single-threaded
        # structures owned by the driver thread; HTTP handlers hand it
        # work through the command queue, whose lock guards only the
        # queue (and the failure it may hold), never a tick
        self._lock = threading.Lock()
        self._commands: List[Tuple[Callable[[], None],
                                   Callable[[BaseException], None]]] = []
        self._streams: List[_Stream] = []
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.failure: Optional[BaseException] = None
        self._failed: Optional[asyncio.Event] = None
        eng = next(iter(router.instances.values())).engine
        self.vocab_size = eng.cfg.vocab_size
        self.default_eos = self.vocab_size - 1
        # this thread's torch state, which the driver thread takes on
        self._grad = torch.is_grad_enabled()
        self._stream = (torch.cuda.current_stream(eng.device)
                        if eng.device.type == "cuda" else None)

    # -- driver thread (owns the fleet) ---------------------------------------

    def _drive(self) -> None:
        try:
            torch.set_grad_enabled(self._grad)
            with contextlib.ExitStack() as stack:
                if self._stream is not None:
                    # the stream's device carries its index
                    torch.cuda.set_device(self._stream.device)
                    stack.enter_context(torch.cuda.stream(self._stream))
                self._drive_loop()
        except Exception as e:        # the driver's boundary: see _fail
            self._fail(e)

    def _drive_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                cmds, self._commands = self._commands, []
            for run, _ in cmds:
                run()
            # freezes (restart/revive stall charges) only drain on
            # ticks, so an idle fleet must keep ticking until its
            # control-plane state settles or /health would report a
            # long-finished recovery forever
            busy = (self.router.unfinished > 0
                    or bool(self.router.backlog)
                    or any(v > 0.0 for v in self.router._frozen.values()))
            if busy:
                self.router.tick()
            self._streams = [s for s in self._streams if not s.publish()]
            if not busy:
                time.sleep(_IDLE_SLEEP_S)

    def _fail(self, exc: BaseException) -> None:
        """Driver side, after a tick (or the loop around it) raised: end
        every open stream with finish_reason "error", fail the commands
        still queued and every later one, and wake :func:`serve_http`."""
        traceback.print_exception(exc)
        with self._lock:
            self.failure = exc
            cmds, self._commands = self._commands, []
        for _, abort in cmds:
            abort(DriverFailed(f"fleet driver failed: {exc!r}"))
        for s in self._streams:
            s.fail()
        self._streams = []
        if self._loop is not None and self._failed is not None:
            self._loop.call_soon_threadsafe(self._failed.set)

    def _call(self, fn: Callable[[], Any]) -> "asyncio.Future":
        """Schedule ``fn`` on the driver thread; resolve an asyncio
        future with its result (or exception).  After a driver failure
        the future fails with :class:`DriverFailed`."""
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future" = loop.create_future()

        def settle(setter, value):
            loop.call_soon_threadsafe(
                lambda: fut.cancelled() or setter(value))

        def run():
            try:
                res = fn()
            except Exception as e:        # surfaced as HTTP 400
                settle(fut.set_exception, e)
            else:
                settle(fut.set_result, res)

        with self._lock:
            if self.failure is None:
                self._commands.append(
                    (run, lambda e: settle(fut.set_exception, e)))
                return fut
        fut.set_exception(DriverFailed(
            f"fleet driver failed: {self.failure!r}"))
        return fut

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._failed = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._driver = threading.Thread(target=self._drive,
                                        name="fleet-driver", daemon=True)
        self._driver.start()

    async def stop(self) -> None:
        self._stop.set()
        if self._driver is not None:
            self._driver.join(timeout=5.0)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def wait_failed(self) -> BaseException:
        """Return the driver's exception once its tick has raised."""
        assert self._failed is not None, "start() first"
        await self._failed.wait()
        assert self.failure is not None
        return self.failure

    # -- HTTP plumbing ----------------------------------------------------------

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                try:
                    method, path, headers = self._parse_head(head)
                except ValueError as e:
                    await self._respond_json(writer, 400,
                                             {"error": str(e)})
                    return
                length = int(headers.get("content-length", "0"))
                if length > _MAX_BODY:
                    await self._respond_json(
                        writer, 413, {"error": "body too large"})
                    return
                body = (await reader.readexactly(length)
                        if length else b"")
                keep = await self._dispatch(method, path, body, writer)
                if not keep:
                    return
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise ValueError(f"malformed request line: {lines[0]!r}")
        method, path, _version = parts
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return method.upper(), path, headers

    @staticmethod
    async def _respond_json(writer: asyncio.StreamWriter, status: int,
                            obj: Any, *, keep_alive: bool = False) -> bool:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed",
                  413: "Payload Too Large",
                  503: "Service Unavailable"}.get(status, "OK")
        payload = json.dumps(obj).encode("utf-8")
        conn = "keep-alive" if keep_alive else "close"
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: {conn}\r\n\r\n".encode("latin-1") + payload)
        await writer.drain()
        return keep_alive

    # -- routing ---------------------------------------------------------------

    async def _dispatch(self, method: str, path: str, body: bytes,
                        writer: asyncio.StreamWriter) -> bool:
        try:
            return await self._route(method, path, body, writer)
        except DriverFailed as e:
            return await self._respond_json(writer, 503, {"error": str(e)})

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> bool:
        path = path.split("?", 1)[0]
        if path == "/v1/completions":
            if method != "POST":
                return await self._respond_json(
                    writer, 405, {"error": "POST only"})
            return await self._completions(body, writer)
        if path == "/health":
            return await self._respond_json(writer, 200,
                                            await self._call(self._health),
                                            keep_alive=True)
        if path == "/instances":
            return await self._respond_json(
                writer, 200, await self._call(self._instances),
                keep_alive=True)
        if path == "/control":
            if method != "POST":
                return await self._respond_json(
                    writer, 405, {"error": "POST only"})
            return await self._control(body, writer)
        return await self._respond_json(
            writer, 404, {"error": f"no route for {path}"})

    # -- /v1/completions --------------------------------------------------------

    async def _completions(self, body: bytes,
                           writer: asyncio.StreamWriter) -> bool:
        try:
            spec = json.loads(body.decode("utf-8") or "{}")
            tokens = _encode_prompt(spec.get("prompt"), self.vocab_size)
            max_tokens = int(spec.get("max_tokens", 16))
            if not 1 <= max_tokens <= 4096:
                raise ValueError("max_tokens must be in [1, 4096]")
            stream = bool(spec.get("stream", False))
            model_id = spec.get("model")
            eos = spec.get("eos_token", self.default_eos)
            if eos is not None:
                eos = int(eos)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return await self._respond_json(writer, 400,
                                            {"error": str(e)})
        loop = asyncio.get_running_loop()
        holder: Dict[str, _Stream] = {}

        def submit() -> Request:
            req = self.router.submit(tokens, max_tokens, eos_token=eos,
                                     model_id=model_id)
            s = _Stream(req, loop)
            holder["stream"] = s
            self._streams.append(s)
            return req

        req = await self._call(submit)
        s = holder["stream"]
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if stream:
            return await self._stream_response(writer, cid, req, s)
        chunks: List[List[int]] = []
        while True:
            batch = await s.queue.get()
            if batch is None:
                break
            chunks.append(batch)
        out = [t for c in chunks for t in c]
        return await self._respond_json(writer, 200, {
            "id": cid, "object": "text_completion",
            "model": req.model_id or "default",
            "choices": [{
                "index": 0, "tokens": out,
                "finish_reason": self._finish_reason(req, s),
            }],
            "usage": {"prompt_tokens": len(req.prompt_tokens),
                      "completion_tokens": len(out),
                      "total_tokens": len(req.prompt_tokens) + len(out)},
        })

    async def _stream_response(self, writer: asyncio.StreamWriter,
                               cid: str, req: Request,
                               s: _Stream) -> bool:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        while True:
            batch = await s.queue.get()
            if batch is None:
                break
            ev = {"id": cid, "object": "text_completion.chunk",
                  "choices": [{"index": 0, "tokens": batch,
                               "finish_reason": None}]}
            writer.write(b"data: " + json.dumps(ev).encode("utf-8")
                         + b"\n\n")
            try:
                await writer.drain()
            except ConnectionError:
                return False          # client went away: stop streaming
        ev = {"id": cid, "object": "text_completion.chunk",
              "choices": [{"index": 0, "tokens": [],
                           "finish_reason": self._finish_reason(req, s)}]}
        writer.write(b"data: " + json.dumps(ev).encode("utf-8") + b"\n\n")
        writer.write(b"data: [DONE]\n\n")
        try:
            await writer.drain()
        except ConnectionError:
            pass
        return False

    @staticmethod
    def _finish_reason(req: Request, s: _Stream) -> str:
        if s.failed or req.state is RequestState.FAILED:
            return "error"
        out = req.committed_output
        if (req.eos_token is not None and out
                and out[-1] == req.eos_token):
            return "stop"
        return "length"

    # -- /health / /instances ---------------------------------------------------

    def _masked_fraction(self, eng) -> float:
        if eng.expert_map is None:
            return 0.0
        return len(eng.expert_map.masked) / eng.expert_map.moe.num_experts

    def _health(self) -> Dict:
        # runs on the driver thread (via _call): between ticks, never
        # during one
        fh = self.router.fleet_health()
        per = {}
        for iid, inst in sorted(self.router.instances.items()):
            if inst.state.value == "dead":
                per[str(iid)] = {"state": "dead"}
                continue
            h = inst.health()
            per[str(iid)] = {
                "state": inst.state.value,
                "serving": h.serving,
                "degraded": h.degraded,
                "healthy_dp": h.healthy_dp, "total_dp": h.total_dp,
                "healthy_moe": h.healthy_moe,
                "total_moe": h.total_moe,
                "expert_coverage": h.expert_coverage,
                "masked_expert_fraction":
                    self._masked_fraction(inst.engine),
                "queue_depth": h.queue_depth,
                "unfinished": h.unfinished,
                "soft_signals": {str(k): v
                                 for k, v in h.soft_signals.items()},
            }
        return {
            "state": fh.state,
            "serving": fh.serving,
            "accepting": fh.accepting,
            "backlog": fh.backlog,
            "shed": fh.shed,
            "spares_available": fh.spares_available,
            "frozen": fh.frozen,
            "starved_models": fh.starved_models,
            "instances": per,
        }

    def _instances(self) -> Dict:
        rows = []
        for iid, inst in sorted(self.router.instances.items()):
            eng = inst.engine
            row = {
                "iid": iid,
                "state": inst.state.value,
                "model_id": inst.model_id,
                "restarts": inst.restarts,
                "decommission_reason": inst.decommission_reason,
            }
            if inst.state.value != "dead":
                row.update({
                    "load": inst.load,
                    "steps": eng.step_no,
                    "masked_expert_fraction":
                        self._masked_fraction(eng),
                    "host_gap_fraction":
                        round(eng.host_gap_fraction(), 6),
                    "overlap": eng.overlap_stats(),
                    "recoveries": [rep.summary()
                                   for rep in eng.reports],
                })
            rows.append(row)
        # every arbiter revive-vs-restart-vs-spare decision, with the
        # counterfactual cost table it priced
        decisions = [ev for ev in self.router.forensics
                     if "decision" in ev]
        return {"instances": rows, "decisions": decisions,
                "ticks": self.router.ticks,
                "now_s": round(self.router.now_s, 6)}

    # -- /control ---------------------------------------------------------------

    async def _control(self, body: bytes,
                       writer: asyncio.StreamWriter) -> bool:
        try:
            spec = json.loads(body.decode("utf-8") or "{}")
            op = spec["op"]
            iid = int(spec["iid"])
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            return await self._respond_json(
                writer, 400, {"error": f"bad control spec: {e}"})

        def run():
            if iid not in self.router.instances:
                raise ValueError(f"unknown instance {iid}")
            if op == "fail_device":
                # device-level fault on one rank next engine step: the
                # arbiter weighs revive vs restart vs spare, and with a
                # surviving DP rank revive keeps the instance serving —
                # the ReviveMoE path the CI smoke drills mid-stream
                from repro_torch.core.fault_codes import ErrorType, Severity
                eng = self.router.instances[iid].engine
                pid = int(spec.get("pid", 1))
                eng.injector.schedule(
                    eng.step_no + 1, pid, severity=Severity.L6,
                    error_type=ErrorType.HBM_ECC,
                    component=spec.get("component", "attn"),
                    mid_step=True)
                return {"ok": True, "op": op, "iid": iid, "pid": pid}
            if op == "lose_instance":
                self.router.lose_instance(
                    iid, reason=spec.get("reason", "control: host loss"))
            elif op == "drain_instance":
                self.router.drain_instance(iid)
            elif op == "planned_restart":
                self.router.planned_restart(iid)
            else:
                raise ValueError(f"unknown op {op!r}")
            return {"ok": True, "op": op, "iid": iid}

        try:
            res = await self._call(run)
        except ValueError as e:
            return await self._respond_json(writer, 400,
                                            {"error": str(e)})
        return await self._respond_json(writer, 200, res,
                                        keep_alive=True)


def serve_http(router, *, host: str = "127.0.0.1",
               port: int = 8077) -> Optional[BaseException]:
    """Blocking entry point: run the front end until interrupted (returns
    None) or until the fleet driver fails (returns its exception, after
    every open stream has ended with finish_reason "error")."""
    fe = ServingFrontend(router, host=host, port=port)

    async def _main():
        await fe.start()
        print(f"serving on http://{fe.host}:{fe.port} "
              f"(POST /v1/completions, GET /health, GET /instances, "
              f"POST /control)", flush=True)
        try:
            exc = await fe.wait_failed()
        finally:
            # an idle keep-alive client must not hold the exit
            with contextlib.suppress(TimeoutError):
                await asyncio.wait_for(fe.stop(), _STOP_TIMEOUT_S)
        print(f"fleet driver failed: {exc!r}", flush=True)
        return exc

    try:
        return asyncio.run(_main())
    except KeyboardInterrupt:
        return None
