"""The port's tensor-parallel serve steps (``distributed/tensor_parallel.py``
and ``Model(tp=...)``) against the JAX package's local model, on the CPU.

Four rank processes (``tests/test_torch_dist_worker.py``, one gloo group
shared by the module's cases, as ``tests/test_torch_distributed.py``'s)
run each family's smoke config in f32 on their ``tp_shard`` of the
port's ``Model.init`` weights, which ``repro``'s model takes as numpy
arrays (leaf by leaf at its own keys and shapes) and ``repro``'s
``save_checkpoint`` writes for the ranks to read (``load_params``): the
ring prefill of 4 rows of unequal lengths, then 3 decode
steps fed ``repro``'s greedy tokens.  The logits assembled from the
ranks (rows over 'data', vocabulary columns over 'model') are within
``TOL`` of ``repro``'s local ``Model.prefill`` / ``decode_step``, and each
step's ``TensorParallel.greedy`` token equals ``repro``'s ``argmax`` over
the padded row.  Two meshes: data 1 x model 4 (the smoke configs' 2 KV
heads do not divide 4: the ring decode is context-parallel over the
window, the audio's cross decode over the frames, and one rank's slots
hold no valid position in the first steps) and data 2 x model 2
(head-parallel).  The MoE families' banks carry 4 redundant slots, so
that the 8 slots split over 'model' 4 (the smoke configs' 6 do not:
``local_shard`` refuses them, as for ``MoEDist``); ``nemotron-4-340b``
runs with ``rules.fsdp`` set, its leaves regathered a layer at a time.

Then ``merge_partials`` and the plain ``paged_attention``'s ``lse_out``:
a ring cut into slices, one call a slice, folded, against one call over
the whole ring (empty slices give lse -inf and zeros, never NaN), in this
process and over the four ranks.  The kernel's ``lse_out`` is held to
the plain version's on the card by
``tests/test_torch_cuda.py::test_lse_out_cuda_vs_plain``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.tensor_parallel import fold_partials
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import lse_ring as _ring
from test_torch_cases import lse_slices as _sliced
from test_torch_cases import one_torch_thread  # noqa: F401
from test_torch_distributed import Group

TOL = 2e-4                # tests/test_torch_distributed.py's TOL
ARCHS = ("qwen2-moe-a2.7b", "internlm2-20b", "deepseek-v3",
         "falcon-mamba-7b", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
         "internvl2-26b", "nemotron-4-340b")
FSDP = ("nemotron-4-340b",)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# the MoE banks: dropless, and 4 + 4 slots (so that they split 4 ways)
MOE = dict(capacity_factor=100.0, num_redundant_experts=4)
# deepseek-v3's query latent at a width no 'model' size here divides: the
# rules keep wdq whole while its heads are split
ODD_Q_LORA = {"q_lora_rank": 63}
B, S_TOK, STEPS, MAX_SEQ = 4, 8, 3, 24
LENGTHS = (8, 5, 8, 3)           # each row's tokens (a vlm's patches first)


def _cfgs(arch, mla=None):
    """(repro's, the port's) smoke config, MoE banks as MOE, the MLA
    config patched by ``mla``."""
    out = []
    for cfg in (jax_smoke_config(arch), get_smoke_config(arch)):
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe_impl="gather_psum",
                moe=dataclasses.replace(cfg.moe, **MOE))
        if mla:
            cfg = dataclasses.replace(
                cfg, mla=dataclasses.replace(cfg.mla, **mla))
        out.append(cfg)
    return out


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_TOK))
             .astype(np.int32)}
    extra = 0
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        extra = cfg.num_patches
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch["lengths"] = np.asarray(LENGTHS, np.int32) + extra
    return batch


def _carried(jm, params):
    """The port's ``params`` as ``repro``'s parameter tree: each leaf of
    ``jm.init``'s structure (traced, nothing drawn) from the port's leaf
    at its key, of the same shape."""
    port = dict(ckpt.flatten(params))

    def leaf(path, spec):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        arr = port.pop(key).numpy()
        assert arr.shape == spec.shape, key
        return jnp.asarray(arr)
    tree = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert not port, sorted(port)
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per arch, computed once: the checkpoint repro wrote, the batch,
    repro's last logits after the prefill and each decode step, and its
    greedy tokens (``argmax`` over the padded row, the step's own
    choice), each fed to the next step."""
    root = tmp_path_factory.mktemp("tp")
    kept = {}

    def get(arch, mla=None):
        key = (arch, tuple(sorted((mla or {}).items())))
        if key not in kept:
            jcfg, pcfg = _cfgs(arch, mla)
            jm = JaxModel(jcfg)
            jparams = _carried(jm, Model(pcfg, device="cpu").init(0))
            path = str(root / f"{arch}{'_mla' if mla else ''}.npz")
            jax_save(path, jparams)
            batch = _batch(jcfg, ARCHS.index(arch))
            last, cache = jax.jit(jm.prefill, static_argnames="max_seq")(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                max_seq=MAX_SEQ)
            step = jax.jit(jm.decode_step)
            logits, greedy = [np.asarray(last)], [
                np.asarray(jnp.argmax(last, -1), np.int32)]
            for _ in range(STEPS):
                last, cache = step(jparams, cache, jnp.asarray(greedy[-1]))
                logits.append(np.asarray(last))
                greedy.append(np.asarray(jnp.argmax(last, -1), np.int32))
            kept[key] = (path, batch, logits, greedy)
        return kept[key]
    return get


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(tmp_path_factory.mktemp("gloo4tp") / "store")
    try:
        yield g
    finally:
        g.close()


def _assemble(results, step, vpad):
    """Step ``step``'s logits (B, vpad) from each rank's rows and
    vocabulary columns."""
    out = np.full((B, vpad), np.nan, np.float32)
    for r in results:
        lo, hi = r["rows"]
        block = np.asarray(r["logits"][step])
        m = r["coords"]["model"]
        n = block.shape[-1]
        out[lo:hi, m * n:(m + 1) * n] = block
    assert not np.isnan(out).any()
    return out


def _tp_run(arch, mesh, group, reference, mla=None):
    """The ranks' TP steps of ``arch`` against repro's local model: the
    logits within TOL, the greedy tokens equal; returns the ranks'
    results."""
    path, batch, want, greedy = reference(arch, mla)
    out = group.run(kind="tp", arch=arch, mesh=MESHES[mesh],
                    axes=("data", "model"), ckpt=path,
                    fsdp=arch in FSDP, moe=MOE, mla=mla, batch=batch,
                    max_seq=MAX_SEQ, feed=greedy[:STEPS])
    vpad = want[0].shape[-1]
    for step in range(STEPS + 1):
        got = _assemble(out, step, vpad)
        np.testing.assert_allclose(got, want[step], rtol=TOL, atol=TOL,
                                   err_msg=f"{arch} {mesh} step {step}")
        for r in out:
            lo, hi = r["rows"]
            np.testing.assert_array_equal(r["tokens"][step],
                                          greedy[step][lo:hi])
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_steps_match_repro_local(arch, mesh, group, reference):
    out = _tp_run(arch, mesh, group, reference)
    # a 'model' rank holds a slice of each split cache leaf
    model = MESHES[mesh][1]
    _, pcfg = _cfgs(arch)
    for r in out:
        for key, shape in r["cache"].items():
            if key.endswith(("/k", "/v")) and pcfg.num_kv_heads % model:
                assert shape[-3] in (MAX_SEQ // model,
                                     pcfg.encoder_seq // model), key


# -- merge_partials and lse_out ---------------------------------------------------

@pytest.mark.parametrize("case", ["gqa", "latent"])
def test_plain_lse_out_slices_fold_to_the_whole(case):
    """A ring of 64 slots in 4 slices; row 1's 10 valid slots leave three
    slices empty and row 2 has none: each slice's lse is the logsumexp of
    its scaled scores, an empty slice's -inf with zeros, and the fold of
    the slices equals one call over the whole ring."""
    H, Hkv, Dh = (12, 2, 64) if case == "gqa" else (16, 1, 48)
    q, k, v, lens = _ring(3, 3, H, Hkv, Dh, 64, [57, 10, 0])
    if case == "latent":
        v = k
    os_, ls = _sliced(paged_attention_plain, q, k, v, lens, 4)
    assert not torch.isnan(os_).any() and os_.dtype == torch.float32
    blocks = torch.arange(3, dtype=torch.int32)[:, None]
    want = paged_attention_plain(q, k, v, blocks, lens)
    G = H // Hkv
    for j in range(4):
        lo, hi = j * 16, (j + 1) * 16
        for b in range(3):
            n = int(min(max(int(lens[b]) - lo, 0), 16))
            if n == 0:
                assert bool((ls[j, b] == -math.inf).all())
                assert bool((os_[j, b] == 0).all())
                continue
            s = torch.einsum("hd,shd->hs", q[b].double(),
                             k[b, lo:lo + n].double().repeat_interleave(
                                 G, dim=1)) / math.sqrt(Dh)
            np.testing.assert_allclose(ls[j, b].numpy(),
                                       torch.logsumexp(s, -1).numpy(),
                                       rtol=1e-6, atol=1e-6)
    got = fold_partials(os_, ls)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert bool((got[2] == 0).all())
    # without lse_out the result is the call's own, in q's type
    assert paged_attention_plain(q, k, v, blocks, lens).dtype == q.dtype


def test_merge_partials_over_four_ranks(group):
    """Each of the four ranks attends its quarter of a ring with
    ``lse_out`` and ``merge_partials`` folds them over the 'model' group:
    the whole ring's attention on every rank."""
    q, k, v, lens = _ring(4, 3, 8, 2, 32, 64, [64, 9, 0])
    out = group.run(kind="merge", q=q.numpy(), k=k.numpy(), v=v.numpy(),
                    lens=lens.numpy())
    blocks = torch.arange(3, dtype=torch.int32)[:, None]
    want = paged_attention_plain(q, k, v, blocks, lens).numpy()
    for r in out:
        assert not np.isnan(r["o"]).any()
        np.testing.assert_allclose(r["o"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["o"][2], 0.0)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_mla_with_a_whole_query_latent_matches_repro_local(
        mesh, group, reference):
    """deepseek-v3 whose query latent (63) 'model' does not divide: the
    rules keep ``wdq`` whole while its heads are split, and the ranks form
    the latent without a gather, within TOL of repro's local model."""
    _tp_run("deepseek-v3", mesh, group, reference, mla=ODD_Q_LORA)


def test_greedy_over_four_ranks_takes_the_lowest_index_on_a_tie(group):
    """``TensorParallel.greedy`` over logits whose 64 columns are split 4
    ways equals ``argmax`` over the whole row: ties across ranks and
    within one go to the lowest index, as ``launch/specs.py`` chooses."""
    logits = np.random.default_rng(7).normal(size=(5, 64)).astype(
        np.float32)
    logits[0, [5, 37]] = 9.0           # ranks 0 and 2
    logits[1, [50, 20, 21]] = 9.0      # ranks 3 and 1, twice in rank 1
    logits[2] = 1.0                    # every column
    logits[3, 63] = 9.0                # the last rank's last column
    out = group.run(kind="greedy", logits=logits)
    want = np.argmax(logits, -1).astype(np.int32)
    assert list(want[:4]) == [5, 20, 0, 63]
    for r in out:
        np.testing.assert_array_equal(r["tokens"], want)
