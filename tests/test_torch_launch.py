"""The port's launcher (``python -m repro_torch.launch.serve``) against
``repro.launch.serve``, on the CPU, and the HTTP drill against it.

``main([...])`` of both packages serves the smoke ``qwen2-moe-a2.7b``
with an attention fault from the same ``weights.npz``: every line that
does not depend on the wall clock must be equal.  The port's own options
(``--device``, ``--dtype``, ``--config``, ``--layers``) and its refusals
are checked beside (the vlm and audio archs fail as ``repro``'s
launcher does), and ``scripts/http_smoke_torch.py --device cpu``
runs once as a subprocess.
"""
import argparse
import json
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve
from test_torch_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# timing-free options of the single-engine run both launchers get
COMMON = ["--mode", "collocated", "--requests", "3", "--max-new", "6",
          "--inject-fault", "attn", "--fault-step", "3"]


def _timing_free(text):
    """The lines that do not depend on the wall clock: no init timings,
    no TTFT, and a recovery summary without its seconds."""
    out = []
    for line in text.splitlines():
        if line.startswith(("init timings:", "TTFT")):
            continue
        out.append(re.sub(r" total=\S+| :: .*", "", line))
    return out


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    return root / "jax", root / "torch"


@pytest.fixture(scope="module")
def single_runs(workdirs):
    """Both launchers' single-engine runs (the reference's first, which
    writes ``weights.npz``; the port's workdir gets a copy)."""
    import contextlib
    import io
    jdir, pdir = workdirs
    outs = []
    for main, wd, extra in ((jax_serve.main, jdir, []),
                            (serve.main, pdir, ["--device", "cpu"])):
        if main is serve.main:
            pdir.mkdir()
            shutil.copy(jdir / "weights.npz", pdir / "weights.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(COMMON + ["--workdir", str(wd)] + extra)
        outs.append((rc, buf.getvalue()))
    return outs


def test_single_engine_lines_equal_repro(single_runs):
    (jrc, jout), (prc, pout) = single_runs
    assert prc == jrc == 0
    assert _timing_free(pout) == _timing_free(jout)
    assert "finished 3/3 requests" in pout
    assert "RECOVERY: [" in pout and "compile=precompiled" in pout


def test_fleet_run_serves_every_request(workdirs, capsys):
    """``--fleet``: the router's virtual clock charges measured costs, so
    only its counts are compared with the request batch."""
    _, pdir = workdirs
    rc = serve.main(["--fleet", "2", "--mode", "collocated", "--requests",
                     "4", "--max-new", "4", "--device", "cpu",
                     "--workdir", str(pdir)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("building fleet: 2 x [qwen2-moe-a2.7b collocated")
    assert re.search(r"finished 4/4 requests in \d+ ticks", out)


def test_hybrid_arch_serves_and_revives(tmp_path, capsys):
    """``--arch jamba-1.5-large-398b --device cpu``: the smoke hybrid
    period serves in the default disaggregated mode and revives an
    attention fault in place."""
    rc = serve.main(["--arch", "jamba-1.5-large-398b", "--device", "cpu",
                     "--requests", "3", "--max-new", "6", "--inject-fault",
                     "attn", "--fault-step", "3", "--workdir",
                     str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("building engine: jamba-1.5-large-398b "
                          "(disaggregated, 2 DP + 2 MoE ranks)")
    assert "finished 3/3 requests" in out
    assert "RECOVERY: [attn/disaggregated]" in out
    assert "compile=precompiled" in out


def test_hybrid_full_config_cuts_whole_periods(capsys):
    """``--config full --layers N`` keeps Jamba's widths and takes N only
    in whole periods of 8 sublayers."""
    args = argparse.Namespace(arch="jamba-1.5-large-398b", config="full",
                              layers=8)
    cfg = serve._config(args)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (8, 8192, 65536)
    assert "depth cut from 72 to 8 layers" in capsys.readouterr().out
    for bad in ("4", "12", "80"):
        with pytest.raises(SystemExit, match="a multiple of 8"):
            serve.main(["--arch", "jamba-1.5-large-398b", "--config", "full",
                        "--layers", bad, "--requests", "0"])


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_vlm_and_audio_arch_fail_as_repros_launcher(tmp_path, arch):
    """Neither launcher serves the vlm or the audio family: the vlm fails
    at its first prefill (the engine passes no patches), the audio at
    engine build (the paged cache refuses an encoder-decoder), with the
    same exception and message in both packages."""
    errors = []
    for main, extra in ((jax_serve.main, []),
                        (serve.main, ["--device", "cpu"])):
        with pytest.raises(Exception) as info:
            main(["--arch", arch, "--requests", "1", "--workdir",
                  str(tmp_path / str(len(errors)))] + extra)
        errors.append((info.type, str(info.value)))
    assert errors[0] == errors[1]
    assert errors[1] == {
        "internvl2-26b": (KeyError, "'patches'"),
        "seamless-m4t-large-v2": (ValueError, "paged serving does not "
                                  "support encoder-decoder (audio) "
                                  "models")}[arch]


def test_device_defaults_to_the_card(tmp_path):
    """Without ``--device cpu`` the launcher runs on the card, and without
    one it raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1", "--workdir", str(tmp_path)])


def test_config_full_and_layers_cut(capsys):
    args = argparse.Namespace(arch="internlm2-20b", config="full", layers=2)
    cfg = serve._config(args)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (2, 6144, 92544)
    assert "depth cut from 48 to 2 layers" in capsys.readouterr().out
    args.layers = None
    assert serve._config(args).num_layers == 48
    args.config = "smoke"
    assert serve._config(args).d_model < 6144
    for bad in (["--layers", "2"],                         # smoke config
                ["--config", "full", "--layers", "0"],
                ["--config", "full", "--layers", "49", "--arch",
                 "internlm2-20b"],
                ["--device", "tpu"], ["--dtype", "float16"]):
        with pytest.raises(SystemExit):
            serve.main(bad + ["--requests", "0"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_http_returns_the_driver_failure(workdirs):
    """A tick that raises ends the open stream with finish_reason "error"
    and ``serve_http`` returns the exception (the launcher then exits 1)."""
    import http.client
    from repro_torch.configs import get_smoke_config
    from repro_torch.fleet import build_fleet
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.frontend import serve_http
    _, pdir = workdirs
    fleet = build_fleet(get_smoke_config("qwen2-moe-a2.7b"), EngineConfig(
        mode="collocated", max_batch=4, max_seq=128, block_size=16,
        num_blocks=256, workdir=str(pdir)), instances=1, device="cpu")

    def tick():
        raise RuntimeError("device lost")

    fleet.tick = tick
    port, result = _free_port(), {}
    th = threading.Thread(target=lambda: result.update(
        exc=serve_http(fleet, port=port)))
    th.start()
    deadline = time.time() + 60
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"prompt": [1, 2, 3], "max_tokens": 4, "stream": True}))
            break
        except ConnectionRefusedError:
            assert time.time() < deadline
            time.sleep(0.05)
    text = conn.getresponse().read().decode()
    conn.close()
    th.join(60)
    assert not th.is_alive()
    assert '"finish_reason": "error"' in text and "data: [DONE]" in text
    assert isinstance(result["exc"], RuntimeError)


def test_http_drill_against_the_launcher(tmp_path):
    """scripts/http_smoke_torch.py on the CPU: the stream lives through
    the mid-stream fault, the revive decision shows, health goes degraded
    then healthy; its last line carries the client's numbers."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "http_smoke_torch.py"),
         "--device", "cpu", "--force-policy", "revive",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "HTTP smoke OK"
    numbers = json.loads(lines[-1])
    assert numbers["tokens"] == 48
    assert numbers["recovery"].startswith("[")
    for key in ("boot_s", "ttft_s", "max_sse_gap_s", "revive_s",
                "restart_to_healthy_s"):
        assert numbers[key] >= 0 and f"client: {key}" in proc.stdout
