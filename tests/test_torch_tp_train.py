"""The port's tensor-parallel train step (``Model(tp=...)``'s loss,
``training.train_loop.make_train_step``, AdamW on the rank's blocks)
against the JAX package's local train step, on the CPU; and ``cfg.remat``.

Four rank processes (``tests/test_torch_dist_worker.py``'s ``train``
job, one gloo group shared by the module's cases, as
``tests/test_torch_tp.py``'s) take 2 train steps of each family's smoke
config in f32 on their ``tp_shard`` of the port's ``Model.init``
weights, with ``cfg.remat`` set (every layer recomputed in the backward,
the FSDP regather included), each rank on its rows of the batches
(``TensorParallel.place``), whose loss masks hold zeros in every row in
different numbers.  ``repro`` takes the same weights as numpy arrays
(``tests/test_torch_tp.py``'s ``_carried``) and ``jax.jit`` of its local
``make_train_step`` the same batches, compiled once an arch and shared
by the arch's meshes.  Held (each tolerance as the tests it comes from
state it):

* each step's ``loss`` and ``grad_norm`` on every rank within
  ``TRAIN_RTOL`` (1e-4 relative; ``tests/test_torch_training.py``'s);
* step 0's gradient (``grads_of``: each rank's blocks of the gradient of
  ``loss / world``), assembled from the ranks under ``collectives``'
  convention (the blocks at their places, the gradients of ranks that
  hold the same block summed), within ``GRAD_SCALE_TOL`` (1e-5 of each
  leaf's largest |gradient|; ``tests/test_torch_distributed.py``'s) of
  the port's own gradient on one rank without tp, and of ``repro``'s
  (read from its first AdamW moment after step 0: ``_first_grads``)
  beyond what the one-rank gradient already differs from
  it by (the smoke Jamba period's smallest leaves, at 1e-4 of the
  model's largest gradient, sit 1.28e-5 of their scale from ``repro``'s
  on one rank: f32 sums in another order, which
  ``tests/test_torch_training.py`` holds within its GRAD_RTOL); and each
  rank's block after ``TensorParallel.reduce_grads`` within the same of
  its block of ``repro``'s;
* the params after step 2, each rank's blocks at their places, within
  ``TRAIN_RTOL`` of each leaf's largest |value| of ``repro``'s; the
  ranks that hold the same block hold it bitwise alike (the sums over
  replicas give every holder the same numbers); AdamW's moments have
  the blocks' shapes.

AdamW runs at lr 1e-3 after one warmup step and eps 1e-3, so that the
two steps move the params by a real update while an update stays a
smooth function of its gradient: at eps 1e-8 a gradient element within
rounding of zero (f32 sums in other orders, ~1e-7 of the leaf's scale)
flips its update by 2 lr, far outside the tolerance.  The meshes: all 8
of ``tests/test_torch_tp.py``'s ``ARCHS`` on data 2 x model 2
(``nemotron-4-340b`` with ``rules.fsdp`` set, its square mesh taking
the broadcast regather), and four on data 1 x model 4 (the smoke
configs' 2 KV heads do not divide 4; Mamba's ``in_proj`` as ``[x_r |
z_r]``; nemotron's FSDP over ('data', 'model') by the gather path).

Then ``cfg.remat`` on one rank: for qwen2-moe-a2.7b, falcon-mamba-7b
and the Jamba period, ``Model.loss`` and its gradients with it set are
bitwise those without, every layer's body runs twice (the forward and
the recomputation) and the aux loss is counted once; and on the 2 x 2
FSDP mesh no leaf that the regather makes is saved for the backward
with it set (without it they are, so the check can tell).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import Model as JaxModel
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train_loop
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import flatten
from repro_torch.training.train_loop import grads_of
from test_torch_cases import one_torch_thread  # noqa: F401
from test_torch_distributed import GRAD_SCALE_TOL, Group
from test_torch_tp import ARCHS, FSDP, MESHES, MOE, _carried, _cfgs

TRAIN_RTOL = 1e-4          # tests/test_torch_training.py
CASES = ([(arch, "2x2") for arch in ARCHS]
         + [(arch, "1x4") for arch in ("qwen2-moe-a2.7b", "deepseek-v3",
                                       "falcon-mamba-7b", "nemotron-4-340b")])
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=2)
B, S_TOK, STEPS = 4, 8, 2
REMAT_ARCHS = ("qwen2-moe-a2.7b", "falcon-mamba-7b", "jamba-1.5-large-398b")


def _batches(cfg, seed):
    """STEPS batches of B rows: tokens, a loss mask with 1 to 3 zeros a
    row, and a vlm's patches or an audio model's frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, S_TOK), np.int32)
        for r in range(B):
            mask[r, rng.choice(S_TOK, r % 3 + 1, replace=False)] = 0
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_TOK))
             .astype(np.int32), "loss_mask": mask}
        if cfg.family == "vlm":
            b["patches"] = rng.normal(
                size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["frames"] = rng.normal(
                size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _np_tree(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _first_grads(opt_cfg, opt, metrics):
    """Step 0's gradients from repro's AdamW state after its first update:
    m = (1 - b1) clip g from zero, clip = min(1, grad_clip / (grad_norm +
    1e-9)) (``repro.training.optimizer.adamw_update``), so g = m / ((1 -
    b1) clip), within an f32 rounding of the gradient itself (the one
    compile an arch takes no ``jax.grad`` beside the step)."""
    gnorm = float(metrics["grad_norm"])
    clip = min(1.0, opt_cfg.grad_clip / (gnorm + 1e-9))
    scale = (1.0 - opt_cfg.betas[0]) * clip
    return {k: v.astype(np.float64) / scale
            for k, v in _np_tree(opt.m).items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per arch, computed once: the checkpoint repro wrote, the batches,
    and from one ``jax.jit`` of repro's local ``make_train_step`` each
    step's metrics, step 0's gradients (:func:`_first_grads`) and the
    params after the last step; and the port's own step 0 gradient on
    one rank, without tp."""
    root = tmp_path_factory.mktemp("tp_train")
    kept = {}

    def get(arch):
        if arch not in kept:
            jcfg, pcfg = _cfgs(arch)
            jm = JaxModel(jcfg)
            jparams = _carried(jm, Model(pcfg, device="cpu").init(0))
            path = str(root / f"{arch}.npz")
            jax_save(path, jparams)
            batches = _batches(jcfg, ARCHS.index(arch))
            opt_cfg = jax_opt.OptimizerConfig(**OPT)
            step = jax.jit(jax_train_loop.make_train_step(jm, opt_cfg))
            params, opt = jparams, jax_opt.init_adamw(jparams)
            metrics = []
            for i, b in enumerate(batches):
                params, opt, m = step(
                    params, opt, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    grads0 = _first_grads(opt_cfg, opt, m)
            # the port's own gradient on one rank, without tp
            local = grads_of(Model(pcfg, device="cpu"),
                             Model(pcfg, device="cpu").init(0),
                             {k: torch.from_numpy(v)
                              for k, v in batches[0].items()})[3]
            local = {k: t.numpy() for k, t in flatten(local)}
            kept[arch] = (path, batches, metrics, grads0, _np_tree(params),
                          local)
        return kept[arch]
    return get


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(tmp_path_factory.mktemp("gloo4tptrain") / "store")
    try:
        yield g
    finally:
        g.close()


def _place(shape, spec, coords, sizes, key):
    """The index (a tuple of slices) of a rank's block of a leaf of
    ``shape`` placed by ``spec``, the rank at ``coords``; Mamba's
    ``in_proj`` split on its last dimension gives two (``tp_shard``'s
    ``[x_r | z_r]``)."""
    index = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else tuple(entry))
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        step = shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    if key.endswith("in_proj") and spec and spec[-1] is not None:
        half = shape[-1] // 2
        last = index[-1]
        lo, hi = last.start // 2, last.stop // 2
        return [tuple(index[:-1]) + (slice(lo, hi),),
                tuple(index[:-1]) + (slice(half + lo, half + hi),)]
    return [tuple(index)]


def _blocks(block, places):
    """A rank's block cut into the pieces that go to ``places``."""
    if len(places) == 1:
        return [block]
    half = block.shape[-1] // 2
    return [block[..., :half], block[..., half:]]


def _assemble(results, field, want, sizes, add=True):
    """Per leaf the whole array from each rank's blocks of ``field``
    (their sum where ranks hold the same block, with ``add``); checks
    that every element is covered."""
    out = {}
    for key, w in want.items():
        full = np.zeros(w.shape, np.float64)
        seen = np.zeros(w.shape, bool)
        for r in results:
            places = _place(w.shape, r["specs"][key], r["coords"], sizes, key)
            for idx, piece in zip(places, _blocks(r[field][key], places)):
                assert piece.shape == full[idx].shape, (key, piece.shape)
                if add:
                    full[idx] += piece
                else:
                    full[idx] = piece
                seen[idx] = True
        assert seen.all(), key
        out[key] = full
    return out


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_train_steps_match_repro_local(arch, mesh, group, reference):
    path, batches, want, grads0, params2, local = reference(arch)
    out = group.run(kind="train", arch=arch, mesh=MESHES[mesh],
                    axes=("data", "model"), ckpt=path, fsdp=arch in FSDP,
                    moe=MOE, remat=True, batches=batches, opt=OPT,
                    batch=batches[0])
    sizes = dict(zip(("data", "model"), MESHES[mesh]))
    for r in out:
        for i, (got, w) in enumerate(zip(r["metrics"], want)):
            for key in ("loss", "grad_norm", "ce", "aux"):
                assert abs(got[key] - w[key]) <= TRAIN_RTOL * abs(w[key]) \
                    + 1e-9, (arch, mesh, i, key, got[key], w[key])
    grads = _assemble(out, "raw", grads0, sizes)
    for key, w in grads0.items():
        scale = max(np.abs(w).max(), 1e-30)
        to_local = np.abs(grads[key] - local[key]).max()
        assert to_local <= GRAD_SCALE_TOL * scale, (key, to_local, scale)
        err = np.abs(grads[key] - w).max()
        one_rank = np.abs(local[key] - w).max()
        assert err <= GRAD_SCALE_TOL * scale + one_rank, (key, err, scale)
        for r in out:
            places = _place(w.shape, r["specs"][key], r["coords"], sizes,
                            key)
            for idx, piece in zip(places, _blocks(r["reduced"][key],
                                                  places)):
                assert np.abs(piece - w[idx]).max() <= (
                    GRAD_SCALE_TOL * scale + one_rank), (key, r["coords"])
    for key, w in params2.items():
        held = {}
        for r in out:
            places = _place(w.shape, r["specs"][key], r["coords"], sizes,
                            key)
            for idx, piece in zip(places, _blocks(r["params"][key], places)):
                err = np.abs(piece - w[idx]).max()
                assert err <= TRAIN_RTOL * np.abs(w).max(), (key, err)
                # replicas of a block: bitwise alike
                tag = tuple((s.start, s.stop) for s in idx)
                if tag in held:
                    np.testing.assert_array_equal(piece, held[tag], key)
                held[tag] = piece
            assert r["moments"][key] == r["params"][key].shape, key


# -- cfg.remat --------------------------------------------------------------------------

def _count_bodies(monkeypatch):
    """Counts :meth:`Model._block_fwd` calls (a hybrid period's
    sublayers each)."""
    calls = []
    inner = Model._block_fwd

    def counted(self, *a, **kw):
        calls.append(1)
        return inner(self, *a, **kw)
    monkeypatch.setattr(Model, "_block_fwd", counted)
    return calls


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_is_bitwise_and_counts_the_aux_once(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)),
        "loss_mask": torch.ones((2, 16), dtype=torch.int32)}
    params = Model(cfg, device="cpu").init(3)
    calls = _count_bodies(monkeypatch)
    out = {}
    for remat in (False, True):
        m = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        calls.clear()
        _, loss, metrics, grads = grads_of(m, params, batch)
        out[remat] = (loss.detach(), metrics, dict(flatten(grads)),
                      len(calls))
    (l0, m0, g0, n0), (l1, m1, g1, n1) = out[False], out[True]
    assert n1 == 2 * n0 > 0        # every body again in the backward
    assert torch.equal(l0, l1)
    assert torch.equal(m0["aux"], m1["aux"])
    assert torch.equal(m0["ce"], m1["ce"])
    if cfg.moe is not None:
        assert float(m1["aux"]) > 0
    assert g0.keys() == g1.keys()
    for key in g0:
        assert torch.equal(g0[key], g1[key]), key


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_aux_equals_repros(arch, reference):
    """The loss under remat counts each MoE layer's aux once: its ``aux``,
    ``ce`` and total on step 0's batch equal ``repro``'s first step's
    (within ``TRAIN_RTOL``), on the same weights."""
    _, batches, want, *_ = reference(arch)
    _, pcfg = _cfgs(arch)
    pm = Model(dataclasses.replace(pcfg, remat=True), device="cpu")
    _, loss, metrics, _ = grads_of(
        pm, Model(pcfg, device="cpu").init(0),
        {k: torch.from_numpy(v) for k, v in batches[0].items()})
    got = dict(metrics, loss=loss)
    for key in ("aux", "ce", "loss"):
        assert abs(float(got[key]) - want[0][key]) <= \
            TRAIN_RTOL * abs(want[0][key]) + 1e-9, key


def test_fsdp_remat_saves_no_regathered_leaf(group, reference):
    """nemotron-4-340b under FSDP on 2 x 2: with ``cfg.remat`` no tensor
    of a shape that the layer regather makes, nor of a split leaf's whole
    layer, is saved for the backward (the regather runs inside the
    checkpoint); without it the layers save the regathered leaves."""
    path, batches, *_ = reference("nemotron-4-340b")
    shapes = {}
    for remat in (False, True):
        out = group.run(kind="saved", arch="nemotron-4-340b",
                        mesh=MESHES["2x2"], axes=("data", "model"),
                        ckpt=path, fsdp=True, moe=MOE, remat=remat,
                        batch=batches[0])
        shapes[remat] = out
    for r in shapes[True]:
        regathered = {tuple(s) for s in r["regathered"]}
        kept = set(map(tuple, r["saved"]))
        assert regathered and kept
        assert not regathered & kept, sorted(regathered & kept)
        # nor a whole layer of a split leaf
        assert not {tuple(s) for s in r["whole"]} & kept
    for r in shapes[False]:
        regathered = {tuple(s) for s in r["regathered"]}
        assert regathered & set(map(tuple, r["saved"]))
