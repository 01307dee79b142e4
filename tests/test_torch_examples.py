"""The port's ``examples/*_torch.py`` twins against ``repro``'s
``examples/``, on the CPU.

Each serving example runs in process, stdout captured: ``repro``'s
original first (its engine writes ``weights.npz`` into the test's
workdir, where ``EngineConfig`` is pointed instead of the original's
``/tmp`` path), then the twin with ``--device cpu`` on a copy of that
``weights.npz``.  Their lines must be equal once :data:`TIMES` has
replaced every time: the ``engine up`` dict (which stages pass its 0.01 s
filter depends on timing), and every number with a unit of ``s`` or
``ms`` (recovery summaries, arbiter estimates, TTFTs, swaps).  The fleet
of ``failover_serving`` runs on pinned virtual costs in both
(``VirtualCostProfile``: the twin's, and the original's ``build_fleet``
given one here), so the arbiter decides alike.

``train_moe_torch.py``'s 300 steps take ~45 s on this CPU, over the 30 s
a test may spend on them, so they run on the card (``chip_smoke.py``'s
``examples`` path); its first 3 steps run against ``repro``'s in
``test_torch_training.py``, beside the same JAX run of that config.
"""
import functools
import importlib.util
import itertools
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

import repro.fleet as jax_fleet
import repro.serving.request as jax_request
import repro_torch.serving.request as torch_request
from repro.serving.engine import EngineConfig as JaxEngineConfig
from test_torch_cases import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# the one regex that strips times before lines are compared
TIMES = re.compile(r"(?<=engine up: ).*|\s*\d+(?:\.\d+)?m?s\b")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    return [TIMES.sub(" <t>", line) for line in text.strip().splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "degraded_serving",
                                  "failover_serving"])
def test_serving_twin_prints_repro_lines(name, tmp_path, capsys,
                                         monkeypatch):
    ref, twin = _load(name), _load(f"{name}_torch")
    ref_dir, twin_dir = tmp_path / "repro", tmp_path / "torch"
    # request ids count from 1 in each run, as in a fresh process (earlier
    # tests in this worker drew others from each package's counter)
    for mod in (jax_request, torch_request):
        monkeypatch.setattr(mod, "_req_counter", itertools.count(1))
    monkeypatch.setattr(ref, "EngineConfig", lambda **kw: JaxEngineConfig(
        **dict(kw, workdir=str(ref_dir))))
    if name == "failover_serving":
        monkeypatch.setattr(ref, "build_fleet", functools.partial(
            jax_fleet.build_fleet,
            cost_profile=jax_fleet.VirtualCostProfile()))
    ref.main()
    want = capsys.readouterr().out
    twin_dir.mkdir()
    shutil.copy(ref_dir / "weights.npz", twin_dir / "weights.npz")
    twin.main(["--device", "cpu", "--workdir", str(twin_dir)])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert got.strip().splitlines()[-1].startswith("OK")


def test_twins_default_to_the_card(monkeypatch):
    """Without ``--device`` a twin runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    monkeypatch.setattr(sys, "argv", ["quickstart_torch.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("quickstart_torch").main()

