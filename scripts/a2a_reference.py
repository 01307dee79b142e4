"""The JAX package's all-to-all MoE layer on a 1 x 2 mesh, stored as a
reference for the port.

Runs ``repro``'s ``MoEDistA2A`` (``a2a`` and ``a2a_fused``) on two host
devices (data 1, model 2: the layout where its expert compute is right)
over the smoke ``qwen2-moe-a2.7b`` at 2 layers in f32, at the default
capacity factor, so copies are dropped at the send capacity and at the
expert capacity; weights are the port's ``Model.init(seed)``, carried
across as numpy.  It asserts that the two agree within 1e-6 and writes
the ``a2a`` logits (the vocabulary's columns), the tokens and the count
of dropped copies (counted on the ``a2a`` run at each of its two
``group_by_expert`` calls a layer, through a wrapper set in this
process only) to ``tests/data/a2a_1x2_reference.npz``, and asserts that
at least one copy was dropped.  ``tests/test_torch_distributed.py``
holds the port's 1 x 2 groups to the file.

    PYTHONPATH=src python scripts/a2a_reference.py

A JAX process on two host devices takes over a minute here, which is why
the suite reads the file instead of running it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED, B, S = "qwen2-moe-a2.7b", 0, 4, 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"
                                         / "a2a_1x2_reference.npz"))
    args = ap.parse_args()
    import repro.distributed.collectives as C
    from repro.configs import get_smoke_config
    from repro.models.model import Model
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.models.model import Model as PortModel

    assert len(jax.devices()) == 2, jax.devices()
    tree = PortModel(port_smoke_config(ARCH), device="cpu").init(SEED)

    def to_jax(t):
        return ({k: to_jax(v) for k, v in t.items()} if isinstance(t, dict)
                else jnp.asarray(t.numpy()))
    params = to_jax(tree)
    cfg = get_smoke_config(ARCH)
    tokens = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    mesh = jax.make_mesh((1, 2), ("data", "model"))

    dropped = {"send": 0, "expert": 0}
    group_by_expert = C.group_by_expert

    def counting(ids, ok, n_groups, cap):
        order, group, slot = group_by_expert(ids, ok, n_groups, cap)
        stage = "send" if n_groups == mesh.shape["model"] else "expert"
        n = jnp.sum(ok) - jnp.sum(group < n_groups)

        def add(v, stage=stage):
            dropped[stage] += int(v)
        jax.debug.callback(add, n)
        return order, group, slot

    out = {"tokens": tokens, "seed": np.int64(SEED)}
    for impl in ("a2a", "a2a_fused"):
        m = Model(dataclasses.replace(cfg, moe_impl=impl),
                  moe_dist=C.MoEDistA2A(mesh, dp_axes=("data",)))
        C.group_by_expert = counting if impl == "a2a" else group_by_expert
        try:
            logits, _, aux = m.logits_full(params, batch)
            logits = np.asarray(logits)
        finally:
            C.group_by_expert = group_by_expert
        jax.effects_barrier()
        out[f"logits_{impl}"] = logits[..., :cfg.vocab_size].astype(
            np.float32)
        out[f"aux_{impl}"] = np.float32(aux)
    out["dropped_send"] = np.int64(dropped["send"])
    out["dropped_expert"] = np.int64(dropped["expert"])
    total = dropped["send"] + dropped["expert"]
    print(f"{ARCH} smoke, {cfg.num_layers} layers, capacity factor "
          f"{cfg.moe.capacity_factor}, batch {B} x {S}: copies dropped at "
          f"the send {dropped['send']}, at the experts {dropped['expert']}; "
          f"a2a and a2a_fused logits differ by "
          f"{np.abs(out['logits_a2a'] - out['logits_a2a_fused']).max():.3e}")
    assert total > 0, "no copy was dropped: the reference would not test drops"
    fused = out.pop("logits_a2a_fused")
    assert np.abs(out["logits_a2a"] - fused).max() <= 1e-6
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({Path(args.out).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
