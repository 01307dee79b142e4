"""The port's distributed MoE layer (``distributed/collectives.py``) on
gloo groups on the CPU, against the JAX package: the smoke
``qwen2-moe-a2.7b`` at 2 layers in f32.

(a) A world of one in this process: each of the four impls against
    ``repro``'s ``MoEDist`` / ``MoEDistA2A`` on ``make_host_mesh()``, in
    ``logits_full`` and its aux loss, at the default capacity factor;
    once with ``MAX_GATHERED_TOKENS`` patched small in both packages, so
    the chunked dispatch runs.
(b) Four ranks (``tests/test_torch_dist_worker.py``, one process each,
    no JAX), shared by the module's cases: on a data 2 x model 2 mesh
    every impl's assembled logits against ``repro``'s local model at
    capacity factor 100 (for ``a2a`` this is the repaired reference
    fault: ``repro``'s own 2 x 2 ``MoEDistA2A`` is 0.988 away on this
    batch, its ``gather_psum`` 1.6e-06), and a B =
    1 ring decode whose tokens stay replicated, its greedy tokens equal
    to ``repro``'s.  On a pod 2 x data 1 x model 2 mesh each pod is a 1 x
    2 EP group: both a2a impls against ``repro``'s 1 x 2 ``MoEDistA2A``
    at the default capacity factor, copies dropped, stored by
    ``scripts/a2a_reference.py`` in ``tests/data/a2a_1x2_reference.npz``.
(c) Gradients on the 2 x 2 mesh: each rank takes the gradient of its
    ``Model.loss`` over the world size (the ranks' losses then sum to the
    global loss, since the layer's collectives backpropagate through
    their transposes), against ``jax.value_and_grad`` of ``repro``'s
    local loss: each rank's expert block against the same block of the
    local gradient; a whole leaf's gradients, summed over every rank
    that holds it, against the local gradient.  The fused impls raise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.distributed.collectives as jax_coll
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models.model import Model as JaxModel
from repro.training.checkpoint import _flatten
import repro_torch.distributed.collectives as pt_coll
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from test_torch_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "test_torch_dist_worker.py"
REFERENCE = ROOT / "tests" / "data" / "a2a_1x2_reference.npz"
ARCH, SEED = "qwen2-moe-a2.7b", 0
IMPLS = ("gather_psum", "gather_psum_fused", "a2a", "a2a_fused")
TOL = 2e-4                   # tests/test_system.py's MoEDist tolerance
GRAD_SCALE_TOL = 1e-5        # of each leaf's largest |gradient|
NO_DROPS = 100.0             # the capacity factor at which nothing drops
RING_STEPS = 6
WORLD = 4


def _cfgs(impl, capacity_factor=None, aux_loss_coef=None):
    """(repro's, the port's) smoke config with ``impl`` and overrides."""
    out = []
    for cfg in (jax_smoke_config(ARCH), get_smoke_config(ARCH)):
        moe = cfg.moe
        if capacity_factor is not None:
            moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
        if aux_loss_coef is not None:
            moe = dataclasses.replace(moe, aux_loss_coef=aux_loss_coef)
        out.append(dataclasses.replace(cfg, moe=moe, moe_impl=impl))
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    """The port's Model.init(SEED) (the workers draw the same), and the
    same arrays as JAX's parameters."""
    tree = Model(get_smoke_config(ARCH), device="cpu").init(SEED)
    return tree, _tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(
        0, get_smoke_config(ARCH).vocab_size, (B, S)).astype(np.int32)


def _jax_logits(jparams, impl, tokens, capacity_factor=None,
                moe_dist=None):
    cfg, _ = _cfgs(impl, capacity_factor)
    logits, _, aux = jax.jit(JaxModel(cfg, moe_dist=moe_dist).logits_full)(
        jparams, {"tokens": jnp.asarray(tokens)})
    return np.asarray(logits), float(aux)


# -- (a) a world of one, in this process ----------------------------------------------

@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(store), 1))
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _port_world_of_one(mesh, params, impl, tokens):
    _, cfg = _cfgs(impl)
    md = pt_coll.make_moe_dist(mesh, impl)
    md.place(tokens.shape[0])
    with torch.no_grad():
        logits, _, aux = Model(cfg, device="cpu", moe_dist=md).logits_full(
            md.shard_params(params), {"tokens": torch.from_numpy(tokens)},
            with_aux=True)
    return logits.numpy(), float(aux)


@pytest.mark.parametrize("impl", IMPLS)
def test_world_of_one_matches_repro_host_mesh(impl, world_of_one, weights):
    params, jparams = weights
    tokens = _tokens(1, 4, 16)
    jmesh = jax_host_mesh()
    want, want_aux = _jax_logits(
        jparams, impl, tokens,
        moe_dist=jax_coll.make_moe_dist(jmesh, impl, dp_axes=("data",)))
    got, got_aux = _port_world_of_one(world_of_one, params, impl, tokens)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert abs(got_aux - want_aux) <= TOL * abs(want_aux)


def test_world_of_one_chunked_dispatch(world_of_one, weights, monkeypatch):
    """64 tokens in chunks of 16: four gathers, routes and combines a
    layer, each chunk at the chunk's capacity; the aux averaged over the
    chunks."""
    params, jparams = weights
    for mod in (jax_coll, pt_coll):
        monkeypatch.setattr(mod, "MAX_GATHERED_TOKENS", 16)
    tokens = _tokens(2, 4, 16)
    impl = "gather_psum"
    md = pt_coll.make_moe_dist(world_of_one, impl)
    assert md.cap_for(64, get_smoke_config(ARCH).moe) == 8
    want, want_aux = _jax_logits(
        jparams, impl, tokens,
        moe_dist=jax_coll.MoEDist(jax_host_mesh(), dp_axes=("data",)))
    got, got_aux = _port_world_of_one(world_of_one, params, impl, tokens)
    full, _ = _jax_logits(jparams, impl, tokens)
    assert np.abs(full - want).max() > 1e-3     # the chunks change drops
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert abs(got_aux - want_aux) <= TOL * abs(want_aux)


# -- (b) four ranks -------------------------------------------------------------------

class Group:
    """WORLD worker processes of one gloo group; :meth:`run` hands every
    rank the same job and returns their results in rank order."""

    def __init__(self, store):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD), str(store)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=str(ROOT)) for r in range(WORLD)]
        self.pool = ThreadPoolExecutor(WORLD)

    def run(self, **job):
        for p in self.procs:
            pickle.dump(job, p.stdin)
            p.stdin.flush()
        futures = [self.pool.submit(pickle.load, p.stdout)
                   for p in self.procs]
        out = [f.result(timeout=300) for f in futures]
        errors = [o["error"] for o in out if "error" in o]
        assert not errors, errors[0]
        return out

    def close(self):
        for p in self.procs:
            try:
                pickle.dump(None, p.stdin)
                p.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.pool.shutdown()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(tmp_path_factory.mktemp("gloo4") / "store")
    try:
        yield g
    finally:
        g.close()


def _assemble(results, key="logits"):
    """The global rows from each rank's share; ranks that hold the same
    rows must agree."""
    B = max(r["rows"][1] for r in results)
    full = [None] * B
    for r in results:
        lo, hi = r["rows"]
        for i in range(lo, hi):
            row = np.asarray(r[key])[i - lo]
            if full[i] is None:
                full[i] = row
            else:
                np.testing.assert_array_equal(row, full[i])
    return np.stack(full)


@pytest.fixture(scope="module")
def local_reference(weights):
    """repro's local model at capacity factor 100 on a batch drawn from a
    seed, computed once a module: (tokens, logits, aux)."""
    _, jparams = weights
    kept = {}

    def get(seed, B, S):
        if (seed, B, S) not in kept:
            tokens = _tokens(seed, B, S)
            kept[seed, B, S] = (tokens, *_jax_logits(
                jparams, "gather_psum", tokens, NO_DROPS))
        return kept[seed, B, S]
    return get


@pytest.fixture(scope="module")
def ring_reference(weights):
    """repro's local ring serve step at capacity factor 100: a B = 1
    prompt of 8 tokens, then RING_STEPS greedy decode steps: (tokens,
    greedy tokens, per-step logits)."""
    _, jparams = weights
    tokens = _tokens(4, 1, 8)
    cfg, _ = _cfgs("gather_psum", NO_DROPS)
    jm = JaxModel(cfg)
    last, cache = jax.jit(jm.prefill, static_argnames="max_seq")(
        jparams, {"tokens": jnp.asarray(tokens)}, max_seq=8 + RING_STEPS)
    decode = jax.jit(jm.decode_step)
    greedy, logits = [], [np.asarray(last)]
    for _ in range(RING_STEPS):
        greedy.append(int(jnp.argmax(last[0, :cfg.vocab_size])))
        last, cache = decode(jparams, cache,
                             jnp.asarray([greedy[-1]], jnp.int32))
        logits.append(np.asarray(last))
    return tokens, greedy, np.stack(logits)


@pytest.mark.parametrize("impl", IMPLS)
def test_four_ranks_match_local(impl, group, local_reference):
    tokens, want, want_aux = local_reference(3, 4, 16)
    out = group.run(kind="forward", impl=impl, mesh=(2, 2),
                    axes=("data", "model"), seed=SEED, tokens=tokens,
                    capacity_factor=NO_DROPS)
    assert sorted(tuple(r["coords"].values()) for r in out) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["rows"] for r in out} == {(0, 2), (2, 4)}
    np.testing.assert_allclose(_assemble(out), want, rtol=TOL, atol=TOL)
    if impl.startswith("gather_psum"):
        # every rank routes the whole gathered batch: the local aux
        for r in out:
            assert abs(r["aux"] - want_aux) <= TOL * abs(want_aux)


@pytest.mark.parametrize("impl", ("gather_psum", "gather_psum_fused"))
def test_four_ranks_b1_ring_decode(impl, group, ring_reference):
    """B = 1 does not split over data 2: the share is replicated, the
    8-token prefill cuts its half of the tokens and gathers them back,
    and each 1-token decode step takes the replicated branch."""
    tokens, want_tokens, want_logits = ring_reference
    out = group.run(kind="ring", impl=impl, mesh=(2, 2),
                    axes=("data", "model"), seed=SEED, tokens=tokens,
                    capacity_factor=NO_DROPS, steps=RING_STEPS)
    for r in out:
        assert r["rows"] == (0, 1)
        assert r["tokens"][0].tolist() == want_tokens
        np.testing.assert_allclose(np.stack(r["logits"]), want_logits,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ("a2a", "a2a_fused"))
def test_pod_mesh_a2a_matches_repro_1x2_with_drops(impl, group):
    """Each pod of a pod 2 x data 1 x model 2 mesh is a 1 x 2 EP group
    serving its own copy of the reference batch at the default capacity
    factor: its logits are repro's 1 x 2 MoEDistA2A's, with its drops."""
    ref = np.load(REFERENCE)
    assert int(ref["dropped_send"]) + int(ref["dropped_expert"]) > 0
    assert int(ref["seed"]) == SEED
    tokens = ref["tokens"]
    B, V = tokens.shape[0], ref["logits_a2a"].shape[-1]
    out = group.run(kind="forward", impl=impl, mesh=(2, 1, 2),
                    axes=("pod", "data", "model"), seed=SEED,
                    tokens=np.concatenate([tokens, tokens]))
    got = _assemble(out)[..., :V]
    for pod in range(2):
        np.testing.assert_allclose(got[pod * B:(pod + 1) * B],
                                   ref["logits_a2a"], rtol=TOL, atol=TOL)
    for r in out:
        assert abs(r["aux"] - float(ref[f"aux_{impl}"])) <= TOL * abs(
            float(ref[f"aux_{impl}"]))


# -- (c) gradients ----------------------------------------------------------------------

GRAD_CASES = {
    # impl: aux_loss_coef (None: the config's).  The a2a layer's aux is
    # the mean of its ranks' losses over their own tokens, as the JAX
    # package's: another function than the local aux, so it is left out
    "gather_psum": None,
    "a2a": 0.0,
}


@pytest.mark.parametrize("impl", GRAD_CASES)
def test_four_ranks_gradients(impl, group, weights):
    _, jparams = weights
    tokens = _tokens(5, 4, 16)
    coef = GRAD_CASES[impl]
    out = group.run(kind="grad", impl=impl, mesh=(2, 2),
                    axes=("data", "model"), seed=SEED, tokens=tokens,
                    capacity_factor=NO_DROPS, aux_loss_coef=coef)
    cfg, pcfg = _cfgs("gather_psum", NO_DROPS, coef)
    batch = {"tokens": jnp.asarray(tokens),
             "loss_mask": jnp.ones(tokens.shape, jnp.int32)}
    (loss, _), g = jax.jit(jax.value_and_grad(JaxModel(cfg).loss,
                                              has_aux=True))(jparams, batch)
    want = _flatten(g)
    e_local = (pcfg.moe.num_experts + pcfg.moe.num_redundant_experts) // 2
    f_local = pcfg.moe.expert_d_ff // 2
    assert set(out[0]["grads"]) == set(want)
    for key, w in want.items():
        scale = float(np.abs(w).max())
        name = key.split("/")[-1]
        if "/moe/" in f"/{key}" and name in ("gate", "up", "down"):
            f_dim = 3 if name in ("gate", "up") else 2
            for r in out:
                d, m = r["coords"]["data"], r["coords"]["model"]
                block = np.take(w[:, m * e_local:(m + 1) * e_local],
                                range(d * f_local, (d + 1) * f_local),
                                axis=f_dim)
                err = np.abs(r["grads"][key] - block).max()
                assert err <= GRAD_SCALE_TOL * scale, (key, r["coords"], err,
                                                       scale)
        else:
            got = sum(r["grads"][key] for r in out)
            err = np.abs(got - w).max()
            assert err <= GRAD_SCALE_TOL * scale, (key, err, scale)
    # each share's loss: the two data shares average to the global loss
    shares = {r["rows"]: r["loss"] for r in out}
    assert abs(np.mean(list(shares.values())) - float(loss)) <= 1e-5 * abs(
        float(loss))


@pytest.mark.parametrize("impl", ("gather_psum_fused", "a2a_fused"))
def test_fused_impls_raise_under_grad(impl, group):
    out = group.run(kind="grad", impl=impl, mesh=(2, 2),
                    axes=("data", "model"), seed=SEED,
                    tokens=_tokens(5, 4, 16), capacity_factor=NO_DROPS)
    for r in out:
        assert "fused MoE kernel has no backward" in r["raised"]
