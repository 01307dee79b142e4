"""The overlap pipeline in the port against ``repro`` and against lockstep,
on the CPU.

``EngineConfig(overlap=True)`` plans and launches step N+1 before step N
drains; a sampling epilogue chains its tokens into the next launch, and
the logits come back through pinned buffers one step late.  At the
sizes of tests/test_async_engine.py, with the same ``weights.npz`` in
both packages: the port's overlap streams equal its lockstep streams and
``repro``'s overlap streams, and ``overlap_stats()`` equals ``repro``'s —
at temperatures 0, 0.3 and 0.8, on GQA, MLA and a sliding window, with
speculation (mispredicted accept counts reconcile and replan), and under
a fault while a step is in flight.  ``export_live_requests`` and
``full_reinit`` with a step in flight commit it first and leak no
speculative token.
"""
import dataclasses
import shutil

import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import ErrorType as JaxErrorType
from repro.core.fault_codes import Severity as JaxSeverity
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplingParams as JaxSampling
from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import ErrorType, Severity
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import SamplingParams
from test_torch_cases import one_torch_thread  # noqa: F401

QWEN, MLA = "qwen2-moe-a2.7b", "deepseek-v3"
PAT_A = [5, 9, 2, 7]
PAT_B = [3, 1]
COMMON = dict(mode="collocated", max_batch=2, max_seq=96, block_size=8,
              num_blocks=64)


def _prompts():
    return [PAT_A * 5, PAT_B * 8]


def _windowed(cfg):
    return dataclasses.replace(cfg, sliding_window=6)


class Shared:
    """One weights.npz per architecture (written by ``repro``'s first
    engine) and one XLA cache for the module's JAX engines."""

    def __init__(self, root):
        self.root = root
        self.n = 0

    def _dir(self, kind):
        self.n += 1
        wd = self.root / f"{self.n}_{kind}"
        wd.mkdir()
        return wd

    def _sampling(self, temperature):
        return dict(temperature=temperature, top_p=0.9, seed=3)

    def jax_engine(self, arch=QWEN, windowed=False, temperature=0.0, **kw):
        cfg = jax_smoke_config(arch)
        cfg = _windowed(cfg) if windowed else cfg
        wd = self._dir("jax")
        weights = self.root / f"weights_{arch}.npz"
        if weights.exists():
            shutil.copy(weights, wd / "weights.npz")
        eng = JaxEngine(cfg, JaxEngineConfig(
            **{**COMMON, "num_dp": 1, **kw}, workdir=str(wd),
            persist_cache_dir=str(self.root / "xla_cache"),
            sampling=JaxSampling(**self._sampling(temperature))))
        if not weights.exists():
            shutil.copy(wd / "weights.npz", weights)
        return eng

    def torch_engine(self, arch=QWEN, windowed=False, temperature=0.0,
                     **kw):
        cfg = get_smoke_config(arch)
        cfg = _windowed(cfg) if windowed else cfg
        weights = self.root / f"weights_{arch}.npz"
        if not weights.exists():      # the reference writes it
            self.jax_engine(arch)
        wd = self._dir("torch")
        shutil.copy(weights, wd / "weights.npz")
        return InferenceEngine(cfg, EngineConfig(
            **{**COMMON, "num_dp": 1, **kw}, workdir=str(wd),
            sampling=SamplingParams(**self._sampling(temperature))),
            device="cpu")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return Shared(tmp_path_factory.mktemp("overlap"))


def _serve(eng, prompts=None, max_new=24):
    reqs = [eng.submit(list(p), max_new) for p in (prompts or _prompts())]
    eng.run(max_steps=400)
    assert all(r.state.value == "finished" for r in reqs), \
        [r.state for r in reqs]
    return [list(r.output_tokens) for r in reqs]


def _triple(shared, **kw):
    """(port overlap, port lockstep, repro overlap) engines served on the
    same prompts: their streams, and the two overlap engines."""
    peng = shared.torch_engine(overlap=True, **kw)
    got = _serve(peng)
    lock = _serve(shared.torch_engine(**kw))
    jeng = shared.jax_engine(overlap=True, **kw)
    return got, lock, _serve(jeng), peng, jeng


# -- config checks ----------------------------------------------------------


@pytest.mark.parametrize("bad,match", [
    (dict(pool_undo="snapshot"), "pool_undo"),
    (dict(admission="serial"), "admission")])
def test_overlap_config_checks(tmp_path, bad, match):
    """Overlap needs row undo and chunked admission, as in ``repro``; the
    options build and run in the port (no ``NotImplementedError``)."""
    with pytest.raises(ValueError, match=match):
        EngineConfig(workdir=str(tmp_path), overlap=True, **bad)
    with pytest.raises(ValueError, match=match):
        JaxEngineConfig(workdir=str(tmp_path), overlap=True, **bad)
    with pytest.raises(ValueError, match="spec_window"):
        EngineConfig(workdir=str(tmp_path), spec_window=40)
    eng = InferenceEngine(get_smoke_config(QWEN), EngineConfig(
        workdir=str(tmp_path / "ok"), overlap=True, spec_window=4),
        device="cpu")
    assert eng._overlap_active
    assert all(ex.scheduler.spec_window == 4 for ex in eng.dp_executors)


# -- token exactness --------------------------------------------------------


@pytest.mark.parametrize("arch,windowed,impl", [
    (QWEN, False, None), (MLA, False, None), (QWEN, True, None),
    (QWEN, False, "megakernel"), (MLA, False, "megakernel")],
    ids=["gqa_moe", "mla_moe", "windowed", "megakernel", "mla_megakernel"])
def test_overlap_matches_lockstep_and_reference(shared, arch, windowed,
                                                impl):
    got, lock, jout, peng, jeng = _triple(shared, arch=arch,
                                          windowed=windowed,
                                          decode_impl=impl)
    assert got == lock == jout
    st = peng.overlap_stats()
    assert st == jeng.overlap_stats()
    assert st["planned_ahead"] > 0        # the pipeline actually piped
    assert st["replans"] == 0             # greedy device argmax is exact
    assert 0.0 <= peng.host_gap_fraction() < 1.0


@pytest.mark.parametrize("temperature", [0.3, 0.8])
def test_overlap_any_temperature(shared, temperature):
    """The device epilogue samples with the host's position-seeded
    uniforms; a last-ulp disagreement could cost a replan, never a
    token."""
    got, lock, jout, peng, jeng = _triple(shared, temperature=temperature)
    assert got == lock == jout
    assert peng.overlap_stats() == jeng.overlap_stats()
    assert peng.overlap_stats()["planned_ahead"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_overlap_with_spec_reconciles(shared, temperature):
    """Speculation makes per-step emit counts unpredictable at plan time:
    the stacked plan-ahead step is unwound (pool rows restored newest
    first) and the true outcome committed via the lockstep path — still
    token-exact, with ``repro``'s counters."""
    got, lock, jout, peng, jeng = _triple(shared, spec_window=6,
                                          temperature=temperature)
    assert got == lock == jout
    st = peng.overlap_stats()
    assert st == jeng.overlap_stats()
    assert st["planned_ahead"] > 0
    assert st["replans"] >= 1
    assert peng.prefill_stats() == jeng.prefill_stats()
    assert peng.spec_histogram() == jeng.spec_histogram()
    assert peng.prefill_stats()["spec_windows"] > 0


def _schedule_fault(eng, severity, error_type):
    eng.injector.schedule(3, 1, severity=severity.L6,
                          error_type=error_type.HBM_ECC, component="attn",
                          mid_step=True)


def test_fault_mid_overlap_replays_to_lockstep_stream(shared):
    """A device fault with a step in flight: the pending step's outcome
    commits (its readback predates the fault), §3.3 rolls back the rest,
    and replay reproduces lockstep's stream and ``repro``'s."""
    kw = dict(num_dp=2, temperature=0.7)
    runs = []
    for make, overlap, sev, err in (
            (shared.torch_engine, True, Severity, ErrorType),
            (shared.torch_engine, False, Severity, ErrorType),
            (shared.jax_engine, True, JaxSeverity, JaxErrorType)):
        eng = make(overlap=overlap, **kw)
        _schedule_fault(eng, sev, err)
        runs.append((_serve(eng), eng))
    (got, peng), (want, _), (jout, jeng) = runs
    assert got == want == jout
    assert peng.reports and peng.reports[0].scenario == \
        jeng.reports[0].scenario
    assert peng.overlap_stats() == jeng.overlap_stats()
    assert peng.overlap_stats()["planned_ahead"] > 0


def _steps_in_flight(eng, n):
    for _ in range(n):
        eng.step()
    assert any(ex._inflight is not None for ex in eng.dp_executors)


def test_export_live_requests_with_step_in_flight(shared):
    """Export with a step in flight commits it first (as ``repro``), and
    the exported requests carry no speculative token."""
    outs = []
    for eng in (shared.torch_engine(overlap=True, spec_window=6),
                shared.jax_engine(overlap=True, spec_window=6)):
        for p in _prompts():
            eng.submit(list(p), 24)
        _steps_in_flight(eng, 6)
        out = eng.export_live_requests(with_kv=False)
        assert all(r.speculative_tokens == 0 for r in out)
        assert not any(ex.has_uncommitted() for ex in eng.dp_executors)
        outs.append([(list(r.prompt_tokens), list(r.output_tokens),
                      r.state.value) for r in out])
    assert outs[0] == outs[1]
    assert outs[0] and all(o for _, o, _ in outs[0])


def test_full_reinit_with_step_in_flight(shared):
    """A restart with a step in flight commits it and requeues everything:
    the streams equal ``repro``'s under the same restart, and a lockstep
    engine's restarted after as many steps."""
    outs = []
    for eng, overlap in ((shared.torch_engine(overlap=True), True),
                         (shared.jax_engine(overlap=True), True),
                         (shared.torch_engine(), False)):
        reqs = [eng.submit(list(p), 24) for p in _prompts()]
        for _ in range(5):
            eng.step()
        assert overlap == any(ex._inflight is not None
                              for ex in eng.dp_executors)
        eng.full_reinit()
        eng.run(max_steps=400)
        assert all(r.state.value == "finished" for r in reqs)
        assert all(r.speculative_tokens == 0 for r in reqs)
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[0] == outs[1] == outs[2]


# -- the staging, on the CPU ---------------------------------------------------


def test_upload_packs_arrays_in_one_copy():
    """One upload of several arrays: each comes back with its dtype, shape
    and values, and owns its bytes (the caller may reuse its arrays)."""
    import numpy as np
    import torch

    from repro_torch.serving.staging import upload
    arrays = [np.arange(7, dtype=np.int32), np.ones((2, 3), np.float32),
              np.asarray(5, np.int64), np.zeros((0,), np.int32)]
    got = upload("cpu", *arrays)
    for a in arrays:
        a[...] = 0
    upload("cpu", np.full(64, 9, np.int64))
    want = [np.arange(7, dtype=np.int32), np.ones((2, 3), np.float32),
            np.asarray(5, np.int64), np.zeros((0,), np.int32)]
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    # one packed buffer: every array a view into the same storage
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1


def test_readback_copies_each_launch():
    """A readback holds its launch's copies, unchanged by later launches
    and by later writes to the device tensors."""
    import numpy as np
    import torch

    from repro_torch.serving.staging import readback
    x = torch.arange(6, dtype=torch.float32).view(2, 3)
    a = readback([x, torch.tensor([4, 5], dtype=torch.int32)])
    x.zero_()
    b = readback([torch.full((5,), 2.0)])
    got_x, got_y = a.wait()
    np.testing.assert_array_equal(got_x, np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    np.testing.assert_array_equal(got_y, [4, 5])
    assert got_y.dtype == np.int32
    np.testing.assert_array_equal(b.wait()[0], np.full(5, 2.0))
