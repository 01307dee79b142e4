"""The attention+MoE model of the serving path.

Mirrors the attention+MoE branch of ``repro.models.model.Model``: the
same layer groups, the same parameter layout (repeated layers stacked on
a leading ``(L, ...)`` axis, so checkpoint keys match) and the same paged
decode step.  A Python loop over the layers replaces ``lax.scan``.
Every decode and chunk step is :meth:`Model.decode_step_paged`; a
prefill chunk is the same call over chunk-width virtual slots.  With
``decode_impl="megakernel"`` each attention+MoE block runs through
``ops.decode_megastep``; dense first-k blocks keep the composed chain.
A whole-prompt prefill (serial admission) is :meth:`Model.prefill_paged`:
the full-sequence forward, its attention through ``ops.flash_prefill``,
returning each layer's raw K/V rows for ``cache_ops.install_prefill``.

The attention-free Mamba family (``family="ssm"``, falcon-mamba) is
ported too: its blocks hold only ``ln1`` and the Mamba mixer, its paged
cache is per-slot ``conv``/``ssm`` state with a batch axis, a whole
prompt's forward returns each layer's final state, and both paths run the
recurrence through ``ops.ssm_scan``.  It cannot chunk its prefill.

The dense, hybrid (Jamba), audio and VLM families and MLA attention are
later slices of the port and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import ffn as Fn
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models.layers import (embed_init, padded_vocab_size,
                                       rms_norm, take_layer)


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        cfg.validate()
        unported = {
            "dense": "Queue 1 item 10", "vlm": "Queue 1 item 10",
            "audio": "Queue 1 item 10",
            "hybrid": "Queue 1 item 1h, the Jamba hybrid period"}
        if cfg.family in unported:
            raise NotImplementedError(
                f"family {cfg.family!r}: only attention+MoE and Mamba "
                f"models are ported so far (ROADMAP "
                f"{unported[cfg.family]})")
        if cfg.family == "moe" and cfg.attention_type != "gqa":
            raise NotImplementedError(
                f"attention_type {cfg.attention_type!r}: MLA and "
                f"deepseek-v3, with the megastep at the latent width, are "
                f"queued (ROADMAP Queue 1 item 1c)")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.vpad = padded_vocab_size(cfg)
        # the megastep's expert_offset, as device data like the JAX
        # package's traced int32 (this model holds the whole bank)
        self.expert_offset = torch.zeros(1, dtype=torch.int32,
                                         device=self.device)
        # per Mamba group: (its A_log, that tensor's version, A)
        self._ssm_A: Dict[str, Any] = {}

    # -- structure -----------------------------------------------------------

    def layer_groups(self):
        """(group_name, n_layers, mixer, ffn_kind, cross) per stack."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return [("layers", cfg.num_layers, "mamba", None, False)]
        groups = []
        if cfg.moe.first_k_dense:
            groups.append(("dense_layers", cfg.moe.first_k_dense, "attn",
                           "dense_first", False))
        groups.append(("layers", cfg.num_layers - cfg.moe.first_k_dense,
                       "attn", "moe", False))
        return groups

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill runs prompt tokens as virtual decode slots
        against the paged pools, which needs every mixer to be attention.
        A Mamba mixer carries per-slot state that must be threaded
        through the prompt in order, so its models keep whole-prompt
        prefills."""
        return all(mixer == "attn"
                   for _, _, mixer, _, _ in self.layer_groups())

    def default_runtime(self) -> Optional[MoE.MoERuntime]:
        if self.cfg.moe is None:
            return None
        return MoE.default_runtime(self.cfg.moe, self.device)

    # -- init ----------------------------------------------------------------

    def init(self, seed: int) -> Dict[str, Any]:
        """Random weights from ``seed``, drawn on the model's device."""
        cfg, dtype = self.cfg, self.dtype
        gen = torch.Generator(device=self.device).manual_seed(seed)
        D = cfg.d_model
        params: Dict[str, Any] = {
            "embed": embed_init(gen, self.vpad, D, dtype),
            "final_norm": torch.ones(D, dtype=dtype, device=self.device),
            "lm_head": embed_init(gen, self.vpad, D, dtype).T.contiguous(),
        }
        for name, n, mixer, ffn_kind, _ in self.layer_groups():
            p: Dict[str, Any] = {
                "ln1": torch.ones((n, D), dtype=dtype, device=self.device)}
            if mixer == "mamba":        # a Mamba block has no FFN
                p["mixer"] = M.mamba_init(gen, cfg, dtype, (n,))
            else:
                p["mixer"] = A.gqa_init(gen, cfg, dtype, (n,))
                p["ln2"] = torch.ones((n, D), dtype=dtype,
                                      device=self.device)
            if ffn_kind == "moe":
                p["moe"] = MoE.moe_init(gen, cfg, dtype, n)
            elif ffn_kind is not None:
                p["ffn"] = Fn.ffn_init(gen, D, cfg.moe.dense_d_ff or cfg.d_ff,
                                       cfg.activation, dtype, (n,))
            params[name] = p
        return params

    def ssm_rates(self, params, name: str) -> torch.Tensor:
        """Mamba group ``name``'s scan rates A = -exp(A_log), (L, d_inner,
        N) f32, computed once per weight load: again only when ``A_log`` is
        another tensor (a reload) or was written in place since."""
        A_log = params[name]["mixer"]["A_log"]
        hit = self._ssm_A.get(name)
        if hit is None or hit[0] is not A_log or hit[1] != A_log._version:
            hit = self._ssm_A[name] = (A_log, A_log._version, M.ssm_A(A_log))
        return hit[2]

    # -- moe application -------------------------------------------------------

    def _moe(self, p, x, runtime, cap):
        y = MoE.moe_apply_local(p, self.cfg, x, runtime, cap=cap)
        return y + MoE.shared_expert_apply(p, self.cfg, x)

    def _cap(self, n_tokens: int) -> int:
        if self.cfg.moe is None:
            return 0
        return MoE.capacity(n_tokens * self.cfg.moe.top_k,
                            MoE.physical_experts(self.cfg.moe),
                            self.cfg.moe.capacity_factor,
                            floor=self.cfg.moe.min_capacity)

    # -- full-sequence forward (whole-prompt prefill) --------------------------

    def _block_fwd(self, p, x, positions, *, mixer, ffn_kind, runtime, cap,
                   ssm_A=None):
        """One block over a whole sequence.  x: (B, S, D).  Returns (x,
        cache entry): the block's raw (B, S, Hkv, Dh) K (rope applied)
        and V, or a Mamba block's final (B, ...) ``conv`` and ``ssm``
        state.  ``ssm_A``: a Mamba block's scan rates."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            out, state = M.mamba_forward(p["mixer"], cfg, h,
                                         return_state=True, A=ssm_A)
            return x + out, state._asdict()
        out, entry = self._gqa_fwd_cache(p["mixer"], h, positions)
        x = x + out
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if ffn_kind == "moe":
            y = self._moe(p["moe"], h2.reshape(-1, h2.shape[-1]), runtime,
                          cap)
            return x + y.reshape(x.shape), entry
        return x + Fn.ffn_apply(p["ffn"], h2, cfg.activation), entry

    def _gqa_fwd_cache(self, p, h, positions):
        out, (k, v) = A.gqa_forward_with_kv(p, self.cfg, h, positions)
        return out, {"k": k, "v": v}

    def _trunk(self, params, x, positions, runtime):
        """Every layer group, layer by layer.  Returns (x, caches): per
        group the stacked (L, B, S, Hkv, Dh) raw K and V, or the stacked
        (L, B, ...) Mamba state."""
        cap = self._cap(x.shape[0] * x.shape[1])
        caches: Dict[str, Any] = {}
        for name, n, mixer, ffn_kind, _ in self.layer_groups():
            rates = self.ssm_rates(params, name) if mixer == "mamba" else None
            entries = []
            for i in range(n):
                x, entry = self._block_fwd(
                    take_layer(params[name], i), x, positions, mixer=mixer,
                    ffn_kind=ffn_kind, runtime=runtime, cap=cap,
                    ssm_A=None if rates is None else rates[i])
                entries.append(entry)
            caches[name] = {key: torch.stack([e[key] for e in entries])
                            for key in entries[0]}
        return x, caches

    def _embed_inputs(self, params, batch):
        x = params["embed"][batch["tokens"].long()]
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        return x, positions

    def logits_full(self, params, batch, runtime=None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S).  Returns
        (logits (B, S, vocab), raw per-layer K/V caches)."""
        cfg = self.cfg
        runtime = runtime if runtime is not None else self.default_runtime()
        x, positions = self._embed_inputs(params, batch)
        x, caches = self._trunk(params, x, positions, runtime)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"], caches

    @torch.no_grad()
    def prefill_paged(self, params, batch, runtime=None):
        """Prefill for the paged serving cache.  ``batch``: ``tokens`` (B,
        S) and optionally ``lengths`` (B,), the real prompt lengths.
        Returns ``(last_logits, raw)``: the logits at each row's last real
        position and, per layer group, the raw K/V rows (L, B, S, Hkv, Dh)
        that ``cache_ops.install_prefill`` writes into pool blocks, or the
        final Mamba state (L, B, ...) that it copies into the request's
        batch slot.  As in the JAX package, a Mamba prompt padded to its
        bucket runs its padding tokens through the recurrence too: the
        state is the one after the bucket, not after the prompt."""
        logits, caches = self.logits_full(params, batch, runtime)
        if "lengths" in batch:
            rows = torch.arange(logits.shape[0], device=logits.device)
            last = logits[rows, batch["lengths"].long() - 1]
        else:
            last = logits[:, -1]
        return last, caches

    # -- paged serving cache ---------------------------------------------------

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None, device=None):
        """Per-layer-group K/V pools with **no batch axis** (requests own
        physical blocks through block tables), plus one trailing *trash*
        block (id ``num_blocks``) that idle rows write into; a Mamba
        group keeps fixed-size per-slot ``conv``/``ssm`` state with a
        batch axis, (L, batch, ...).  Callers tell pool leaves from
        per-slot state by varying ``batch``."""
        dtype = dtype or self.dtype
        device = self.device if device is None else device
        caches = {}
        for name, n, mixer, _, _ in self.layer_groups():
            if mixer == "mamba":
                caches[name] = M.mamba_init_state(self.cfg, batch, dtype,
                                                  device, (n,))
            else:
                caches[name] = A.gqa_paged_pools(
                    self.cfg, num_blocks + 1, block_size, dtype, device,
                    (n,))
        return caches

    @torch.no_grad()
    def decode_step_paged(self, params, cache, token, page, runtime=None):
        """One decode step against the paged cache.

        token: (B,) int; ``page`` carries the per-step paging arrays
        (``tables`` (B, max_blk), ``seq_lens`` (B,) valid length including
        this step's token, ``write_bid``/``write_off`` (B,) where it
        lands; idle rows point at the trash block with seq_len 0), all
        int32 on the model's device.  The pools, and a Mamba model's
        per-slot state (every slot's, idle ones too, as in the JAX
        package), are updated in place.  Returns ``(logits, cache)``.
        """
        cfg = self.cfg
        runtime = runtime if runtime is not None else self.default_runtime()
        x = params["embed"][token.long()]                # (B, D)
        cap = self._cap(x.shape[0])
        if cfg.decode_impl == "megakernel" and cfg.moe is not None:
            # every layer attends over the same window: its lower bounds
            # (zeros without a window) are computed once per step
            starts = A.window_starts(cfg, page["seq_lens"])
            page = dict(page, starts=torch.zeros_like(page["seq_lens"])
                        if starts is None else starts)
        for name, n, mixer, ffn_kind, _ in self.layer_groups():
            rates = self.ssm_rates(params, name) if mixer == "mamba" else None
            for i in range(n):
                x = self._block_decode_paged(
                    take_layer(params[name], i), x,
                    take_layer(cache[name], i), page, runtime, cap, mixer,
                    ffn_kind, None if rates is None else rates[i])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"], cache

    def _block_decode_paged(self, p, x, csl, page, runtime, cap, mixer,
                            ffn_kind, ssm_A=None):
        """One block's decode step.  ``csl`` is the layer's slice of the
        cache: its K/V pools, or its Mamba state (and ``ssm_A`` the
        block's scan rates)."""
        cfg = self.cfg
        if cfg.decode_impl == "megakernel" and ffn_kind == "moe":
            return self._block_decode_megastep(p, x, csl, page, runtime,
                                               cap)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            return x + M.mamba_decode(p["mixer"], cfg, h, csl, A=ssm_A)
        x = x + A.gqa_decode_paged(p["mixer"], cfg, h, csl, page)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if ffn_kind == "moe":
            return x + self._moe(p["moe"], h2, runtime, cap)
        return x + Fn.ffn_apply(p["ffn"], h2, cfg.activation)

    def _block_decode_megastep(self, p, x, pools, page, runtime, cap):
        """One attention+MoE block through ``ops.decode_megastep``: the
        attention -> residual -> norm -> route -> expert FFN (routed +
        shared) -> combine chain is one call (its plain version on the
        CPU).  The QKV projection, rope and the pool write stay outside,
        shared with the composed path, so the §3.3 row-level undo
        manifest is unchanged.  Paging arrays and MoERuntime tables ride
        in as data: recovery edits change nothing that is launched."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = A.gqa_decode_qkv(p["mixer"], cfg, h, page)
        A.gqa_write_token(pools, page, k, v)
        moe_p = p["moe"]
        shared = moe_p.get("shared")
        y, _ = ops.decode_megastep(
            q, pools["k"], pools["v"], page["tables"], page["seq_lens"],
            page["starts"], x, p["mixer"]["wo"], p["ln2"], moe_p["router"],
            runtime.logical_to_physical, runtime.replica_count,
            runtime.expert_mask, moe_p["gate"], moe_p["up"], moe_p["down"],
            self.expert_offset, shared["w_gate"] if shared else None,
            shared["w_up"] if shared else None,
            shared["w_down"] if shared else None,
            top_k=cfg.moe.top_k, cap=cap,
            e_local=MoE.physical_experts(cfg.moe), eps=cfg.norm_eps)
        return y
