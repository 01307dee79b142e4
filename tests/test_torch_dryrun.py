"""The port's dry run (``launch/specs.py``, ``dryrun.py``, ``dryrun_all.py``)
against the JAX package's, on the CPU.

* ``step_arg_specs``' shapes and dtypes, leaf by leaf, equal ``repro``'s
  ``jax.eval_shape`` specs for every ``ASSIGNED_ARCHS`` entry at every
  ``INPUT_SHAPES`` entry (full configs, nothing allocated); the port's
  fused latent ring ``ckr`` (..., W, 1, R + dr) stands for ``repro``'s
  ``c_kv`` and ``k_rope``.
* ``model_flops_params``, ``layer_units``, ``with_units`` and
  ``apply_cfg_patch`` equal ``repro``'s; the wire model equals
  ``parse_collectives`` fed one synthetic HLO line per op, dtype and
  group size.
* ``make_step`` at smoke size against ``repro``'s jitted steps, weights
  carried across (``tests/test_torch_ring.py::carry``): next tokens
  equal, caches within the ring tests' TOL, the train step's metrics and
  params within the training tests' TRAIN_RTOL.
* The trace: its FLOPs equal ``FlopCounterMode``'s; a smoke dry run over
  a fake 16 x 16 group (2 x 2 for the MoE smoke configs, whose 6 experts
  do not split 16 ways) has the ``argument_bytes`` that ``repro``'s
  ``PartitionSpec``s give (``build_in_shardings`` on a stub mesh, as
  ``tests/test_torch_sharding.py`` gets them); for a dense arch rank
  FLOPs x data size equal the unsharded trace's; the full-depth trace
  equals the 2- and 4-unit extrapolation on a homogeneous stack.
* One full-width ``kimi-k2-1t-a32b`` ``decode_32k`` dry run in a child
  process: its record has ``repro``'s keys, within its time, and its
  resident memory grows by under 1 GB.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as jax_sharding
from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models.model import Model as JaxModel
from repro.training.optimizer import init_adamw as jax_init_adamw
from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 InputShape, get_config, get_smoke_config)
from repro_torch.launch import dryrun, dryrun_all, specs
from repro_torch.launch.mesh import MeshLayout, make_mesh
from repro_torch.models.model import Model
from repro_torch.training.optimizer import init_adamw
from test_torch_ring import (TOL, _clone, assert_cache_close, both, carry,
                             make_batch)
from test_torch_cases import one_torch_thread  # noqa: F401

# repro.launch.dryrun forces 512 host devices at import (for its own
# process); this worker's JAX keeps the flags it had
_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jax_dryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = Path(__file__).resolve().parents[1]
TRAIN_RTOL = 1e-4            # tests/test_torch_training.py
# the keys of repro's record (repro/launch/dryrun.py, run_dryrun)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "moe_impl",
               "lower_s", "compile_s", "memory", "per_device_flops",
               "per_device_bytes", "cost_extrapolation", "collectives",
               "collectives_4unit", "collective_wire_bytes", "roofline",
               "model_flops", "hlo_flops_total", "useful_flops_ratio",
               "params", "elapsed_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes"}


def _jax_leaves(tree):
    """(key path, leaf) of a JAX tree, keys as the port's trees name them
    (a tuple's position as its number)."""
    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)
    return [(tuple(key(k) for k in p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


# -- step_arg_specs ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_step_arg_specs_equal_repros(arch):
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        jcfg, cfg = jax_get_config(arch, name), get_config(arch, name)
        want = _jax_leaves(jax_specs.step_arg_specs(
            JaxModel(jcfg, dtype=jnp.bfloat16), jcfg, JAX_SHAPES[name]))
        got = list(dryrun._flat(specs.step_arg_specs(
            Model(cfg, torch.bfloat16, device="cpu"), cfg, shape)))
        assert all(t.device.type == "meta" for _, t in got)
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in want}
        got = {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in got}
        for key in [k for k in got if k[-1] == "ckr"]:
            # the port's fused latent ring: repro's c_kv and k_rope
            shape_, dt = got.pop(key)
            ckv = want.pop(key[:-1] + ("c_kv",))
            krope = want.pop(key[:-1] + ("k_rope",))
            assert shape_ == ckv[0][:-1] + (1, ckv[0][-1] + krope[0][-1])
            assert ckv[0][:-1] == krope[0][:-1]
            assert dt == ckv[1] == krope[1]
        assert got == want, (arch, name)


# -- configs, useful FLOPs and the wire model ---------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_units_and_patch_equal_repros(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dryrun.model_flops_params(cfg) == jax_dryrun.model_flops_params(
        jcfg)
    assert dryrun.layer_units(cfg) == jax_dryrun.layer_units(jcfg)
    for n in (2, 4):
        got, want = dryrun.with_units(cfg, n), jax_dryrun.with_units(jcfg, n)
        assert (got.num_layers, got.encoder_layers) == (
            want.num_layers, want.encoder_layers)
        # (repro's count_params sums in int32, which overflows here)
        assert dryrun.model_flops_params(got) == \
            jax_dryrun.model_flops_params(want)
    patch = {"sliding_window": 4096, "num_heads": 8}
    if cfg.moe is not None:
        patch.update({"moe.min_capacity": 1, "moe.capacity_factor": 2.0})
    got = dryrun.apply_cfg_patch(cfg, patch)
    want = jax_dryrun.apply_cfg_patch(jcfg, patch)
    for field in ("sliding_window", "num_heads"):
        assert getattr(got, field) == getattr(want, field)
    if cfg.moe is not None:
        assert (got.moe.min_capacity, got.moe.capacity_factor) == (
            want.moe.min_capacity, want.moe.capacity_factor)
    assert dryrun.apply_cfg_patch(cfg, None) is cfg


HLO_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute")


@pytest.mark.parametrize("op", HLO_OPS)
def test_wire_model_equals_parse_collectives(op):
    for dtype, width in (("bf16", 2), ("f32", 4), ("s32", 4)):
        for n in (1, 2, 4, 16):
            for groups in (f"replica_groups=[{16 // n},{n}]<=[16]",
                           "replica_groups={{" + ",".join(
                               map(str, range(n))) + "}}"):
                for start in ("", "-start"):
                    line = (f"  %x = {dtype}[8,128]{{1,0}} {op}{start}("
                            f"{dtype}[8,128]{{1,0}} %p), {groups}")
                    want = jax_dryrun.parse_collectives(line)[op]
                    size = 8 * 128 * width
                    assert want["bytes"] == size
                    assert dryrun.wire_bytes(op, size, n) == pytest.approx(
                        want["wire"], rel=1e-12), (line, n)


# -- make_step against repro's jitted steps -----------------------------------------------

@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """qwen2-moe-a2.7b (smoke, dropless), repro's weights in both: the
    prefill, one decode step after it and one train step, each through
    ``make_step`` in both packages (repro's jitted)."""
    jm, jparams, pm, pparams = carry(tmp_path_factory.mktemp("dryrun"),
                                     "qwen2-moe-a2.7b")
    batch = make_batch(pm.cfg, 13, seed=5)
    jb, pb = both(batch)
    jrt, prt = jm.default_runtime(), pm.default_runtime()
    out = {}
    jtok, jcache = jax.jit(jax_specs.make_step(jm, "prefill"))(jparams, jb,
                                                               jrt)
    ptok, pcache = specs.make_step(pm, "prefill")(pparams, pb, prt)
    out["prefill"] = (jtok, jcache, ptok, _clone(pcache))
    jtok2, jcache2 = jax.jit(jax_specs.make_step(jm, "decode"))(
        jparams, jcache, jtok, jrt)
    ptok2, pcache2 = specs.make_step(pm, "decode")(
        pparams, pcache, torch.from_numpy(np.array(jtok)), prt)
    out["decode"] = (jtok2, jcache2, ptok2, pcache2)
    tb = dict(batch, loss_mask=np.ones_like(batch["tokens"]))
    tb["loss_mask"][-1, -4:] = 0
    jtb, ptb = both(tb)
    jp, jopt, jmet = jax.jit(jax_specs.make_step(jm, "train"))(
        jparams, jax_init_adamw(jparams), jtb)
    pp, popt, pmet = specs.make_step(pm, "train")(
        pparams, init_adamw(pparams), ptb)
    out["train"] = (jp, jopt, jmet, pp, popt, pmet)
    return out


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_make_step_serves_as_repros(stepped, kind):
    jtok, jcache, ptok, pcache = stepped[kind]
    assert ptok.dtype == torch.int32
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    assert_cache_close(pcache, jcache, TOL)


def test_make_step_trains_as_repros(stepped):
    jp, jopt, jmet, pp, popt, pmet = stepped["train"]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        want = float(jmet[key])
        assert abs(float(pmet[key]) - want) <= TRAIN_RTOL * abs(want), key
    assert int(popt.step) == int(jopt.step) == 1
    want = dict(_jax_leaves(jp))
    for path, got in dryrun._flat(pp):
        w = np.asarray(want[path], np.float64)
        err = np.abs(got.double().numpy() - w)
        assert (err <= TRAIN_RTOL * np.abs(w).max()).all(), path


# -- the trace ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "deepseek-v3"))
def test_trace_flops_equal_flop_counter_mode(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = InputShape("t", 8, 2, kind)
        model = Model(cfg, torch.bfloat16, device="cpu")
        args = specs.step_arg_specs(model, cfg, shape)
        step = specs.make_step(model, kind)
        rec = dryrun.trace(step, args)
        assert rec["collectives"] == {} and rec["wire"] == 0
        assert rec["argument_bytes"] == sum(
            t.numel() * t.element_size() for _, t in dryrun._flat(args))
        assert rec["temp_bytes"] > 0 and rec["bytes"] > 0
        mode = FakeTensorMode()
        with mode:
            fake = dryrun._map2(lambda p, t, s: torch.empty(
                tuple(t.shape), dtype=t.dtype), args, args)
        with mode, FlopCounterMode(display=False) as counter:
            step(*fake)
        assert rec["flops"] == counter.get_total_flops() > 0, kind


def _stub(layout):
    return types.SimpleNamespace(
        shape=dict(zip(layout.mesh_dim_names, layout.shape)),
        axis_names=layout.mesh_dim_names)


def repro_argument_bytes(jcfg, shape, layout, monkeypatch):
    """Per-rank bytes of ``repro``'s step arguments as its
    ``build_in_shardings`` places them: each leaf over the product of
    its spec's axes."""
    from jax.sharding import PartitionSpec
    monkeypatch.setattr(jax_sharding, "NamedSharding",
                        lambda mesh, spec: spec)
    monkeypatch.setattr(jax_dryrun, "NamedSharding", lambda mesh, spec: spec)
    jm = JaxModel(jcfg, dtype=jnp.bfloat16)
    args = jax_specs.step_arg_specs(jm, jcfg, shape)
    shardings = jax_dryrun.build_in_shardings(jm, jcfg, shape,
                                              _stub(layout), args)
    sizes = dict(zip(layout.mesh_dim_names, layout.shape))
    leaves = jax.tree_util.tree_leaves(args)
    placed = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(placed)
    total = 0
    for leaf, spec in zip(leaves, placed):
        n = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else
                         (entry or ())):
                n *= sizes[axis]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


SMOKE_MESHES = {"internlm2-20b": (16, 16), "qwen2-moe-a2.7b": (2, 2),
                "deepseek-v3": (2, 2)}
SMOKE_SHAPES = {"train": InputShape("train_s", 32, 32, "train"),
                "prefill": InputShape("prefill_s", 32, 32, "prefill"),
                "decode": InputShape("decode_s", 64, 32, "decode")}


@pytest.fixture(scope="module")
def smoke_ranks():
    """Each SMOKE_MESHES arch's rank-0 trace at each SMOKE_SHAPES kind over
    a fake group of its mesh, and the unsharded trace of internlm2-20b's."""
    out = {}
    for arch, mesh_shape in SMOKE_MESHES.items():
        cfg = get_smoke_config(arch)
        with dryrun.fake_group(math.prod(mesh_shape)):
            mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
            for kind, shape in SMOKE_SHAPES.items():
                out[arch, kind] = dryrun.rank_step(cfg, shape, mesh,
                                                   "gather_psum")
    assert not torch.distributed.is_initialized()
    cfg = get_smoke_config("internlm2-20b")
    model = Model(cfg, torch.bfloat16, device="cpu")
    for kind, shape in SMOKE_SHAPES.items():
        out["unsharded", kind] = dryrun.trace(
            specs.make_step(model, kind),
            specs.step_arg_specs(model, cfg, shape))
    return out


@pytest.mark.parametrize("kind", SMOKE_SHAPES)
@pytest.mark.parametrize("arch", SMOKE_MESHES)
def test_rank_argument_bytes_equal_repros_placement(arch, kind, smoke_ranks,
                                                     monkeypatch):
    import repro.configs as jax_configs
    rec = smoke_ranks[arch, kind]
    layout = MeshLayout(SMOKE_MESHES[arch], ("data", "model"))
    jcfg = jax_configs.get_smoke_config(arch)
    shape = SMOKE_SHAPES[kind]
    want = repro_argument_bytes(jcfg, jax_configs.InputShape(
        shape.name, shape.seq_len, shape.global_batch, kind), layout,
        monkeypatch)
    assert rec["argument_bytes"] == want
    assert rec["flops"] > 0 and rec["wire"] > 0
    ops = set(rec["collectives"])
    # the whole leaves gathered at the entry; the MoE layer's dispatch
    # and combine on top
    assert "all-gather" in ops
    if arch != "internlm2-20b":
        assert {"all-reduce", "reduce-scatter"} <= ops
    if kind == "train":
        assert "all-reduce" in ops      # the gradients over DP


@pytest.mark.parametrize("kind", SMOKE_SHAPES)
def test_dense_rank_flops_are_the_data_share(kind, smoke_ranks):
    """No tensor parallelism: a dense rank runs its batch share's whole
    compute, so its FLOPs x the data axis equal the unsharded step's."""
    rec = smoke_ranks["internlm2-20b", kind]
    want = smoke_ranks["unsharded", kind]["flops"]
    assert rec["flops"] * SMOKE_MESHES["internlm2-20b"][0] == want


def test_full_depth_equals_the_extrapolation():
    cfg = dataclasses.replace(get_smoke_config("internlm2-20b"),
                              num_layers=6)
    shape = SMOKE_SHAPES["prefill"]
    with dryrun.fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        full = dryrun.rank_step(cfg, shape, mesh, "gather_psum")
        ext = dryrun.extrapolated_cost(cfg, shape, mesh, "gather_psum")
    assert ext["units"] == 6
    for key in ("flops", "bytes", "wire"):
        assert ext[key] == pytest.approx(full[key], rel=1e-12), key
        assert ext["per_unit"][key] > 0


# -- the command line ----------------------------------------------------------------------

def test_kimi_full_width_dry_run_allocates_nothing(tmp_path):
    """kimi-k2-1t-a32b at full width (~1 T parameters), decode_32k on the
    16 x 16 mesh, in a child process: a record with repro's keys in under
    300 s, and the child's resident memory grows by under 1 GB."""
    out = tmp_path / "kimi.json"
    code = (
        "import json, resource, sys, time\n"
        "from repro_torch.launch.dryrun import run_dryrun\n"
        "base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "t0 = time.perf_counter()\n"
        "rec = run_dryrun('kimi-k2-1t-a32b', 'decode_32k',\n"
        "                 extrapolate=False, verbose=False)\n"
        "rec['_seconds'] = time.perf_counter() - t0\n"
        "rec['_grew_kb'] = (resource.getrusage(resource.RUSAGE_SELF)"
        ".ru_maxrss - base)\n"
        f"json.dump(rec, open({str(out)!r}, 'w'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
    assert rec["memory"]["code_bytes"] is None
    assert rec["_seconds"] < 300
    assert rec["_grew_kb"] < 1 << 20
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    # ~1 T parameters, of which a rank holds its shards (> 1 GiB of them)
    assert rec["params"]["total"] > 1e12
    assert rec["memory"]["argument_bytes"] > 1 << 30
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert 0 < rec["useful_flops_ratio"] < 1


def test_cli_list_and_arguments(capsys):
    assert dryrun.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(ALL_ARCHS)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2-moe-a2.7b"])


@pytest.mark.parametrize("flag", ["--donate", "--cache-carry"])
def test_flags_without_a_counterpart_are_refused(flag, capsys):
    """repro's perf knobs that the port cannot act on exit 2 with the
    reason, before any trace; run_dryrun refuses donate_state too."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k",
                     flag])
    assert exc.value.code == 2
    assert "no counterpart in the port" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no buffer donation"):
        dryrun.run_dryrun("qwen2-moe-a2.7b", "decode_32k",
                          donate_state=True)


def test_dryrun_all_records_a_timeout(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun_all, "RESULTS_DIR", str(tmp_path))
    rec = dryrun_all.run_combo("qwen2-moe-a2.7b", "decode_32k", False,
                               timeout_s=1)
    assert rec["error"] == "timeout after 1s"
    err = tmp_path / "qwen2-moe-a2.7b__decode_32k__16x16.json.err"
    assert json.loads(err.read_text())["error"] == rec["error"]
    table = dryrun_all.summary().splitlines()
    assert len(table) == 2 + len(ASSIGNED_ARCHS)
    row = next(x for x in table if x.startswith("| qwen2-moe-a2.7b |"))
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[1 + list(INPUT_SHAPES).index("decode_32k")] == (
        "16x16 error: timeout after 1s; 2x16x16 not run")
