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
With ``attention_type="mla"`` (deepseek-v3) the mixer is multi-head
latent attention: one fused latent pool ``ckr`` a layer, decode through
paged attention at Hkv = 1 over R + dr, the megastep's readout through
``Model.mla_post``, cached per weight version.

The attention-free Mamba family (``family="ssm"``, falcon-mamba) is
ported too: its blocks hold only ``ln1`` and the Mamba mixer, its paged
cache is per-slot ``conv``/``ssm`` state with a batch axis, a whole
prompt's forward returns each layer's final state, and both paths run the
recurrence through ``ops.ssm_scan``.  It cannot chunk its prefill.

The dense family (``family="dense"``: internlm2-20b's GQA, minicpm3-4b's
MLA; SwiGLU or squared-ReLU FFNs of width ``d_ff``) runs the same blocks
with a dense FFN in every layer; it has no experts.

The hybrid family (``family="hybrid"``, Jamba) stacks periods of
``hybrid_period`` sublayers ``sub_i``: attention at ``hybrid_attn_index``,
Mamba elsewhere, each followed by an MoE on the sublayers where ``i %
moe_layer_period == 1`` and a dense FFN on the others.  A period's cache
entry holds both kinds of state: ``{"attn": its K/V pools, "ssm": the
stack of its Mamba sublayers' per-slot states}``.  It cannot chunk its
prefill, and the megastep never runs in it (its attention sublayer
carries a dense FFN).

The vlm family (internvl2-26b) is the dense model with precomputed patch
embeddings (``batch["patches"]``, (B, num_patches, D)) before the
tokens.  The audio family (seamless-m4t-large-v2) is an encoder-decoder:
a non-causal encoder stack ``enc_layers`` over precomputed frame
embeddings (``batch["frames"]``, (B, encoder_seq, D)) and ``enc_norm``,
then decoder ``layers`` whose blocks add cross-attention (``ln_cross``,
``cross``) after self-attention.  Neither can chunk its prefill, and
the paged cache refuses the audio family, as ``repro``'s does.

Besides the paged cache, every family has ``repro``'s ring-cache serve
step: :meth:`Model.prefill` builds per-row ring caches of ``max_seq``
slots (W = min(window, max_seq)) and :meth:`Model.decode_step` attends
over them through ``ops.paged_attention``, each ring viewed as a pool of
one block a row (``attention.ring_page``); the audio decoder's cache
entry is ``{"self": its rings, "cross": the encoder's K/V per layer}``,
and the cache carries ``pos`` (B,), each row's next position.  Rings and
states are updated in place.

With ``moe_dist`` (``repro_torch.distributed.collectives``) every MoE
layer runs over a mesh of processes: this rank's share of the batch
against its block of the expert bank, the capacity reckoned from the
global token count, and the megastep off.

:meth:`Model.loss` is ``repro``'s training loss: the full-sequence
forward under grad (on the card through ``flash_prefill``, ``expert_ffn``
and their backward kernels), next-token cross entropy, and the MoE
layers' load-balance term, which :meth:`logits_full` sums when asked
(``with_aux``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import ffn as Fn
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models.layers import (cross_entropy_loss, embed_init,
                                       padded_vocab_size, rms_norm,
                                       take_layer)



class MetaFactories(TorchFunctionMode):
    """Tensor factories called with a ``device`` make meta tensors and
    draw nothing, so :meth:`Model.init` under it gives shapes alone."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device=None, moe_dist=None):
        """moe_dist: the distributed MoE layer
        (``repro_torch.distributed.collectives.MoEDist`` or ``MoEDistA2A``)
        that runs every MoE layer over this rank's share of the batch and
        its block of the expert bank; None: a single rank."""
        cfg.validate()
        self.cfg = cfg
        self.moe_dist = moe_dist
        self.dtype = dtype
        self.device = resolve_device(device)
        self.vpad = padded_vocab_size(cfg)
        # the megastep's expert_offset, as device data like the JAX
        # package's traced int32 (this model holds the whole bank)
        self.expert_offset = torch.zeros(1, dtype=torch.int32,
                                         device=self.device)
        # per Mamba group (a hybrid period's: per group and sublayer):
        # (its A_log, that tensor's version, A)
        self._ssm_A: Dict[str, Any] = {}
        # per MLA group: ((its wuv, wo), their versions, w_post)
        self._w_post: Dict[str, Any] = {}

    # -- structure -----------------------------------------------------------

    def layer_groups(self):
        """(group_name, n_layers, mixer, ffn_kind, cross) per stack."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return [("layers", cfg.num_layers, "mamba", None, False)]
        if cfg.family == "audio":
            return [("enc_layers", cfg.encoder_layers, "attn", "dense",
                     False),
                    ("layers", cfg.num_layers, "attn", "dense", True)]
        if cfg.hybrid_period:
            return [("periods", cfg.num_layers // cfg.hybrid_period,
                     "hybrid", None, False)]
        if cfg.moe is None:         # dense, vlm
            return [("layers", cfg.num_layers, "attn", "dense", False)]
        groups = []
        if cfg.moe.first_k_dense:
            groups.append(("dense_layers", cfg.moe.first_k_dense, "attn",
                           "dense_first", False))
        groups.append(("layers", cfg.num_layers - cfg.moe.first_k_dense,
                       "attn", "moe", False))
        return groups

    def period_sublayers(self):
        """A hybrid period's sublayers: (name, mixer, ffn_kind) each."""
        cfg = self.cfg
        return [(f"sub_{i}", "attn" if i == cfg.hybrid_attn_index
                 else "mamba",
                 "moe" if i % cfg.moe.moe_layer_period == 1 else "dense")
                for i in range(cfg.hybrid_period)]

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill runs prompt tokens as virtual decode slots
        against the paged pools, which needs every mixer to be attention.
        A Mamba mixer carries per-slot state that must be threaded
        through the prompt in order, so its models keep whole-prompt
        prefills; so do the vlm and audio families, whose prefills embed
        inputs that are not tokens."""
        if self.cfg.family in ("vlm", "audio"):
            return False
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
        for name, n, mixer, ffn_kind, cross in self.layer_groups():
            if mixer == "hybrid":
                params[name] = {
                    sub: self._block_init(gen, n, sub_mixer, sub_ffn)
                    for sub, sub_mixer, sub_ffn in self.period_sublayers()}
            else:
                params[name] = self._block_init(gen, n, mixer, ffn_kind,
                                                cross)
        if cfg.family == "audio":
            params["enc_norm"] = torch.ones(D, dtype=dtype,
                                            device=self.device)
        return params

    def _block_init(self, gen, n: int, mixer: str, ffn_kind,
                    cross: bool = False):
        """``n`` stacked blocks of one (mixer, ffn_kind); a block without
        an FFN (a falcon-mamba layer) has no ``ln2``, and a decoder block
        of the audio family (``cross``) adds ``ln_cross`` and ``cross``,
        its cross-attention's GQA weights."""
        cfg, dtype = self.cfg, self.dtype
        D = cfg.d_model
        p: Dict[str, Any] = {
            "ln1": torch.ones((n, D), dtype=dtype, device=self.device)}
        if mixer == "mamba":
            p["mixer"] = M.mamba_init(gen, cfg, dtype, (n,))
        else:
            init = A.mla_init if cfg.attention_type == "mla" else A.gqa_init
            p["mixer"] = init(gen, cfg, dtype, (n,))
        if cross:
            p["ln_cross"] = torch.ones((n, D), dtype=dtype,
                                       device=self.device)
            p["cross"] = A.gqa_init(gen, cfg, dtype, (n,))
        if ffn_kind is not None:
            p["ln2"] = torch.ones((n, D), dtype=dtype, device=self.device)
        if ffn_kind == "moe":
            p["moe"] = MoE.moe_init(gen, cfg, dtype, n)
        elif ffn_kind == "dense_first":
            p["ffn"] = Fn.ffn_init(gen, D, cfg.moe.dense_d_ff or cfg.d_ff,
                                   cfg.activation, dtype, (n,))
        elif ffn_kind == "dense":
            p["ffn"] = Fn.ffn_init(gen, D, cfg.d_ff, cfg.activation, dtype,
                                   (n,))
        return p

    def ssm_rates(self, params, name: str,
                  sub: Optional[str] = None) -> torch.Tensor:
        """Mamba group ``name``'s scan rates A = -exp(A_log), (L, d_inner,
        N) f32 — of its sublayer ``sub`` in a hybrid period group —
        computed once per weight load: again only when ``A_log`` is
        another tensor (a reload) or was written in place since.  Under
        grad, for an ``A_log`` that requires it, A is computed anew in the
        graph and the cache is neither read nor filled."""
        group = params[name] if sub is None else params[name][sub]
        A_log = group["mixer"]["A_log"]
        if torch.is_grad_enabled() and A_log.requires_grad:
            # a training forward: A inside the graph, the cache untouched
            return M.ssm_A(A_log)
        key = name if sub is None else f"{name}/{sub}"
        hit = self._ssm_A.get(key)
        if hit is None or hit[0] is not A_log or hit[1] != A_log._version:
            hit = self._ssm_A[key] = (A_log, A_log._version, M.ssm_A(A_log))
        return hit[2]

    def _period_rates(self, params, name: str) -> Dict[str, torch.Tensor]:
        """A hybrid group's scan rates, per Mamba sublayer."""
        return {sub: self.ssm_rates(params, name, sub)
                for sub, mixer, _ in self.period_sublayers()
                if mixer == "mamba"}

    def mla_post(self, params, name: str) -> torch.Tensor:
        """MLA group ``name``'s absorbed readouts ``mla_post_matrix``, (L,
        H * (R + dr), D) in the parameters' type, built once per weight
        load: again only when ``wuv`` or ``wo`` is another tensor or was
        written in place since.  (The JAX package rebuilds it inside every
        step; at deepseek-v3's width it is 1.06 GB a layer in bf16.)"""
        mixer = params[name]["mixer"]
        key = (mixer["wuv"], mixer["wo"])
        versions = tuple(t._version for t in key)
        hit = self._w_post.get(name)
        if (hit is None or any(a is not b for a, b in zip(hit[0], key))
                or hit[1] != versions):
            self._w_post.pop(name, None)   # free the old ones first
            post = torch.stack([
                A.mla_post_matrix(take_layer(mixer, i), self.cfg)
                for i in range(key[0].shape[0])])
            hit = self._w_post[name] = (key, versions, post)
        return hit[2]

    # -- moe application -------------------------------------------------------

    def _moe(self, p, x, runtime, cap, aux=None):
        """Routed plus shared experts over x (T, D).  ``aux``: a list that
        takes the layer's load-balance loss, or None (not computed)."""
        if self.moe_dist is not None:
            out = self.moe_dist.apply(p, self.cfg, x, runtime, cap,
                                      with_aux=aux is not None)
            if aux is None:
                y = out
            else:
                y, layer_aux = out
                aux.append(layer_aux)
        elif aux is None:
            y = MoE.moe_apply_local(p, self.cfg, x, runtime, cap=cap)
        else:
            y, layer_aux = MoE.moe_apply_local(p, self.cfg, x, runtime,
                                               cap=cap, with_aux=True)
            aux.append(layer_aux)
        return y + MoE.shared_expert_apply(p, self.cfg, x)

    def _cap(self, n_tokens: int) -> int:
        """The per-expert capacity for ``n_tokens`` tokens of this rank
        (under ``moe_dist``: of its share, reckoned as the global count)."""
        if self.cfg.moe is None:
            return 0
        if self.moe_dist is not None:
            return self.moe_dist.cap_for(
                self.moe_dist.global_tokens(n_tokens), self.cfg.moe)
        return MoE.capacity(n_tokens * self.cfg.moe.top_k,
                            MoE.physical_experts(self.cfg.moe),
                            self.cfg.moe.capacity_factor,
                            floor=self.cfg.moe.min_capacity)

    # -- full-sequence forward (whole-prompt prefill) --------------------------

    def _block_fwd(self, p, x, positions, *, mixer, ffn_kind, runtime, cap,
                   ssm_A=None, causal=True, enc_out=None, enc_positions=None,
                   max_seq=0, aux=None):
        """One block over a whole sequence.  x: (B, S, D).  Returns (x,
        cache entry): the block's raw (B, S, Hkv, Dh) K (rope applied)
        and V, or with ``max_seq`` their ring of min(window, max_seq)
        slots a row (MLA: the latent rows, raw or as a ring); a Mamba
        block's final (B, ...) ``conv`` and ``ssm`` state; None for a
        non-causal block (the audio encoder's).  ``ssm_A``: a Mamba
        block's scan rates.  ``enc_out`` (B, F, D) at ``enc_positions``:
        what a decoder block with cross-attention attends to.  ``aux``:
        see :meth:`_moe`."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            out, state = M.mamba_forward(p["mixer"], cfg, h,
                                         return_state=True, A=ssm_A)
            entry = state._asdict()
        elif not causal:            # the audio encoder's (GQA) blocks
            out = A.gqa_forward(p["mixer"], cfg, h, positions, causal=False,
                                window=cfg.sliding_window)
            entry = None
        elif cfg.attention_type == "mla":
            out, entry = self._mla_fwd_cache(p["mixer"], h, positions,
                                             max_seq)
        else:
            out, entry = self._gqa_fwd_cache(p["mixer"], h, positions,
                                             max_seq)
        x = x + out
        if enc_out is not None:
            hc = rms_norm(x, p["ln_cross"], cfg.norm_eps)
            x = x + A.gqa_forward(p["cross"], cfg, hc, positions,
                                  causal=False, kv_input=enc_out,
                                  kv_positions=enc_positions, use_rope=False)
        return self._ffn(p, x, ffn_kind, runtime, cap, aux), entry

    def _ffn(self, p, x, ffn_kind, runtime, cap, aux=None):
        """A block's FFN half, its residual included: x (..., D).
        ``aux``: see :meth:`_moe`."""
        if ffn_kind is None:
            return x
        h2 = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        if ffn_kind == "moe":
            y = self._moe(p["moe"], h2.reshape(-1, h2.shape[-1]), runtime,
                          cap, aux)
            return x + y.reshape(x.shape)
        return x + Fn.ffn_apply(p["ffn"], h2, self.cfg.activation)

    def _gqa_fwd_cache(self, p, h, positions, max_seq=0):
        out, (k, v) = A.gqa_forward_with_kv(p, self.cfg, h, positions)
        entry = {"k": k, "v": v}
        if max_seq:
            entry = _ring_from_full(entry, positions, self.cfg.sliding_window,
                                    max_seq)
        return out, entry

    def _mla_fwd_cache(self, p, h, positions, max_seq=0):
        """The fused latent rows (B, S, 1, R + dr), the pool's layout, or
        with ``max_seq`` their ring."""
        out, (c_kv, k_rope) = A.mla_forward_with_cache(p, self.cfg, h,
                                                       positions)
        entry = {"ckr": torch.cat([c_kv, k_rope], dim=-1)[:, :, None]}
        if max_seq:
            entry = _ring_from_full(entry, positions, self.cfg.sliding_window,
                                    max_seq)
        return out, entry

    def _trunk(self, params, x, positions, runtime, *, max_seq=0,
               enc_out=None, enc_positions=None, aux=None):
        """Every decoder layer group, layer by layer (the audio encoder is
        :meth:`_encode`'s).  Returns (x, caches): per group the stacked
        (L, B, S, Hkv, Dh) raw K and V (MLA: the (L, B, S, 1, R + dr)
        latent rows), or with ``max_seq`` their (L, B, W, ...) rings, or
        the stacked (L, B, ...) Mamba state; a hybrid group's ``{"attn":
        K and V, "ssm": (L, n_mamba, B, ...) state}``.  ``enc_out`` goes
        to the groups with cross-attention.  ``aux``: a list that takes
        each MoE layer's load-balance loss in layer order (a hybrid
        period's MoE sublayers included), or None."""
        cap = self._cap(x.shape[0] * x.shape[1])
        caches: Dict[str, Any] = {}
        for name, n, mixer, ffn_kind, cross in self.layer_groups():
            if name == "enc_layers":
                continue
            entries = []
            if mixer == "hybrid":
                rates = self._period_rates(params, name)
                for i in range(n):
                    x, entry = self._period_fwd(
                        take_layer(params[name], i), x, positions, runtime,
                        cap, {sub: a[i] for sub, a in rates.items()},
                        max_seq, aux)
                    entries.append(entry)
            else:
                rates = (self.ssm_rates(params, name) if mixer == "mamba"
                         else None)
                for i in range(n):
                    x, entry = self._block_fwd(
                        take_layer(params[name], i), x, positions,
                        mixer=mixer, ffn_kind=ffn_kind, runtime=runtime,
                        cap=cap, ssm_A=None if rates is None else rates[i],
                        enc_out=enc_out if cross else None,
                        enc_positions=enc_positions, max_seq=max_seq,
                        aux=aux)
                    entries.append(entry)
            caches[name] = _stack(entries)
        return x, caches

    def _period_fwd(self, p, x, positions, runtime, cap, rates, max_seq=0,
                    aux=None):
        """One hybrid period over a whole sequence, sublayer by sublayer.
        ``rates``: each Mamba sublayer's scan rates.  Returns (x, {"attn":
        the attention sublayer's raw K/V (or ring), "ssm": the Mamba
        sublayers' final states stacked on a leading axis})."""
        attn, states = None, []
        for sub, mixer, ffn_kind in self.period_sublayers():
            x, entry = self._block_fwd(
                p[sub], x, positions, mixer=mixer, ffn_kind=ffn_kind,
                runtime=runtime, cap=cap, ssm_A=rates.get(sub),
                max_seq=max_seq, aux=aux)
            if mixer == "attn":
                attn = entry
            else:
                states.append(entry)
        return x, {"attn": attn, "ssm": _stack(states)}

    def _encode(self, params, frames, runtime=None):
        """The audio encoder over precomputed frame embeddings (B, F, D):
        ``encoder_layers`` non-causal blocks, then ``enc_norm``."""
        cfg = self.cfg
        positions = torch.arange(frames.shape[1], dtype=torch.int32,
                                 device=frames.device)
        x = frames
        for i in range(cfg.encoder_layers):
            x, _ = self._block_fwd(
                take_layer(params["enc_layers"], i), x, positions,
                mixer="attn", ffn_kind="dense", runtime=runtime, cap=0,
                causal=False)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, params, enc_out):
        """Each decoder layer's cross-attention K and V of the encoder's
        output (B, F, D): {"k", "v"} of (L, B, F, Hkv, Dh), no rope."""
        cfg = self.cfg
        B, F, _ = enc_out.shape
        shape = (B, F, cfg.num_kv_heads, cfg.resolved_head_dim())
        cross = params["layers"]["cross"]
        return {key: torch.stack([(enc_out @ w).reshape(shape)
                                  for w in cross[f"w{key}"]])
                for key in ("k", "v")}

    def _embed_inputs(self, params, batch):
        """The embedded inputs (B, S, D) and their positions: a vlm row
        is its ``patches`` (B, num_patches, D) then its tokens."""
        x = params["embed"][batch["tokens"].long()]
        if self.cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        return x, positions

    def logits_full(self, params, batch, runtime=None, *, max_seq=0,
                    with_aux=False):
        """Full-sequence forward over ``batch["tokens"]`` (B, S), a vlm's
        ``patches`` before them, an audio model's decoder attending to
        the encoding of ``batch["frames"]``.  Returns (logits (B, S,
        vocab), per-layer caches as :meth:`_trunk` builds them; an audio
        model's decoder entry is ``{"self": ..., "cross":
        :meth:`_cross_kv`}``), and with ``with_aux`` also the MoE
        layers' load-balance losses summed in layer order (0-d f32; zero
        without MoE layers), as ``repro``'s third output."""
        cfg = self.cfg
        runtime = runtime if runtime is not None else self.default_runtime()
        x, positions = self._embed_inputs(params, batch)
        enc_out = enc_positions = None
        if cfg.family == "audio":
            enc_out = self._encode(params, batch["frames"].to(x.dtype),
                                   runtime)
            enc_positions = torch.arange(enc_out.shape[1],
                                         dtype=torch.int32, device=x.device)
        aux = [] if with_aux else None
        x, caches = self._trunk(params, x, positions, runtime,
                                max_seq=max_seq, enc_out=enc_out,
                                enc_positions=enc_positions, aux=aux)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.family == "audio":
            caches["layers"] = {"self": caches["layers"],
                                "cross": self._cross_kv(params, enc_out)}
        if not with_aux:
            return x @ params["lm_head"], caches
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer_aux in aux:
            total = total + layer_aux
        return x @ params["lm_head"], caches, total

    # -- training ------------------------------------------------------------

    def loss(self, params, batch, runtime=None):
        """Next-token cross entropy over ``batch["tokens"]`` where
        ``batch["loss_mask"]`` is 1 (a vlm's over its text positions only,
        after the patches), plus ``aux_loss_coef * aux / max(n_moe, 1)``
        with ``aux`` the MoE layers' summed load-balance loss.  Returns
        ``(total, {"ce": ce, "aux": aux})``, 0-d f32 tensors."""
        cfg = self.cfg
        logits, _, aux = self.logits_full(params, batch, runtime,
                                          with_aux=True)
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_patches:]
        labels = batch["tokens"][:, 1:]
        mask = batch["loss_mask"][:, 1:].float()
        ce = cross_entropy_loss(logits[:, :-1], labels, mask, cfg.vocab_size)
        aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
        total = ce + aux_coef * aux / max(self._num_moe_layers(), 1)
        return total, {"ce": ce, "aux": aux}

    def _num_moe_layers(self) -> int:
        cfg = self.cfg
        if cfg.moe is None:
            return 0
        if cfg.hybrid_period:
            per = sum(1 for i in range(cfg.hybrid_period)
                      if i % cfg.moe.moe_layer_period == 1)
            return per * (cfg.num_layers // cfg.hybrid_period)
        return cfg.num_layers - cfg.moe.first_k_dense

    def param_specs(self) -> Dict[str, Any]:
        """The tree :meth:`init` draws, as ``meta`` tensors of its shapes
        and dtypes (nothing is allocated or drawn)."""
        with MetaFactories():
            return Model(self.cfg, self.dtype, device="cpu").init(0)

    def count_params(self) -> int:
        """The number of parameters :meth:`init` draws, from their shapes
        alone (nothing is allocated)."""
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return tree.numel()
        return count(self.param_specs())

    @staticmethod
    def _last(logits, batch):
        """The logits at each row's last real position (``lengths``)."""
        if "lengths" not in batch:
            return logits[:, -1]
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, batch["lengths"].long() - 1]

    @torch.no_grad()
    def prefill(self, params, batch, runtime=None, max_seq: int = 0):
        """Prefill for the ring cache.  ``batch`` as :meth:`logits_full`'s,
        optionally with ``lengths`` (B,), each row's real length (a vlm
        row's counts its patches).  ``max_seq``: the rings' size (>= the
        sequence; 0: the sequence's length).  Returns ``(last_logits,
        cache)``: the logits at each row's last real position, and the
        per-group rings (or Mamba states) with ``pos`` (B,) int32, each
        row's next position.  As in the JAX package, a padded row's rings
        hold its padding's K/V past its length, never valid at decode."""
        cfg = self.cfg
        S = batch["tokens"].shape[1] + (cfg.num_patches
                                        if cfg.family == "vlm" else 0)
        logits, caches = self.logits_full(params, batch, runtime,
                                          max_seq=max_seq or S)
        if "lengths" in batch:
            pos = batch["lengths"]
        else:
            pos = torch.full((logits.shape[0],), S, device=logits.device)
        caches["pos"] = pos.to(torch.int32)
        return self._last(logits, batch), caches

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
        return self._last(logits, batch), caches

    # -- paged serving cache ---------------------------------------------------

    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None, device=None):
        """Per-layer-group K/V pools with **no batch axis** (requests own
        physical blocks through block tables), plus one trailing *trash*
        block (id ``num_blocks``) that idle rows write into; a Mamba
        group keeps fixed-size per-slot ``conv``/``ssm`` state with a
        batch axis, (L, batch, ...), and a hybrid group both: ``{"attn":
        its pools, "ssm": (L, n_mamba, batch, ...) state}``.  Callers tell
        pool leaves from per-slot state by varying ``batch``."""
        dtype = dtype or self.dtype
        device = self.device if device is None else device
        caches = {}
        for name, n, mixer, _, cross in self.layer_groups():
            if name == "enc_layers":
                continue
            if cross:
                raise ValueError(
                    "paged serving does not support encoder-decoder "
                    "(audio) models")
            if mixer == "hybrid":
                n_mamba = sum(mx == "mamba"
                              for _, mx, _ in self.period_sublayers())
                caches[name] = {
                    "attn": A.gqa_paged_pools(
                        self.cfg, num_blocks + 1, block_size, dtype, device,
                        (n,)),
                    "ssm": M.mamba_init_state(self.cfg, batch, dtype,
                                              device, (n, n_mamba))}
            elif mixer == "mamba":
                caches[name] = M.mamba_init_state(self.cfg, batch, dtype,
                                                  device, (n,))
            elif self.cfg.attention_type == "mla":
                caches[name] = A.mla_paged_pools(
                    self.cfg, num_blocks + 1, block_size, dtype, device,
                    (n,))
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
        mega = cfg.decode_impl == "megakernel" and self.moe_dist is None
        for name, n, mixer, ffn_kind, _ in self.layer_groups():
            if mixer == "hybrid":
                rates = self._period_rates(params, name)
                for i in range(n):
                    x = self._period_decode(
                        take_layer(params[name], i), x,
                        take_layer(cache[name], i), rates, i,
                        functools.partial(self._block_decode_paged,
                                          page=page, runtime=runtime,
                                          cap=cap))
                continue
            rates = self.ssm_rates(params, name) if mixer == "mamba" else None
            post = (self.mla_post(params, name)
                    if mega and ffn_kind == "moe"
                    and cfg.attention_type == "mla" else None)
            for i in range(n):
                x = self._block_decode_paged(
                    take_layer(params[name], i), x,
                    take_layer(cache[name], i), page, runtime, cap, mixer,
                    ffn_kind, None if rates is None else rates[i],
                    None if post is None else post[i])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"], cache

    def _block_decode_paged(self, p, x, csl, page, runtime, cap, mixer,
                            ffn_kind, ssm_A=None, w_post=None):
        """One block's decode step.  ``csl`` is the layer's slice of the
        cache: its K/V (or latent) pools, or its Mamba state (and ``ssm_A``
        the block's scan rates).  ``w_post``: an MLA block's absorbed
        readout, for the megastep."""
        cfg = self.cfg
        if (cfg.decode_impl == "megakernel" and mixer == "attn"
                and ffn_kind == "moe" and self.moe_dist is None):
            return self._block_decode_megastep(p, x, csl, page, runtime,
                                               cap, w_post)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            x = x + M.mamba_decode(p["mixer"], cfg, h, csl, A=ssm_A)
        else:
            decode = (A.mla_decode_paged if cfg.attention_type == "mla"
                      else A.gqa_decode_paged)
            x = x + decode(p["mixer"], cfg, h, csl, page)
        return self._ffn(p, x, ffn_kind, runtime, cap)

    def _period_decode(self, p, x, csl, rates, i, block):
        """Period ``i`` of a hybrid group's decode step, sublayer by
        sublayer: ``block(p_sub, x, sub_cache, mixer, ffn_kind, ssm_A)``
        is the paged or the ring block step.  ``csl``: the period's cache
        entry; Mamba sublayer j updates its slice ``j`` of the state
        stack in place, the attention sublayer its pools or ring.
        ``rates``: the group's scan rates per Mamba sublayer."""
        j = 0
        for sub, mixer, ffn_kind in self.period_sublayers():
            if mixer == "attn":
                sub_cache = csl["attn"]
            else:
                sub_cache = take_layer(csl["ssm"], j)
                j += 1
            x = block(p[sub], x, sub_cache, mixer=mixer, ffn_kind=ffn_kind,
                      ssm_A=rates[sub][i] if sub in rates else None)
        return x

    def _block_decode_megastep(self, p, x, pools, page, runtime, cap,
                               w_post=None):
        """One attention+MoE block through ``ops.decode_megastep``: the
        attention -> residual -> norm -> route -> expert FFN (routed +
        shared) -> combine chain is one call (its plain version on the
        CPU).  The QKV projection, rope and the pool write stay outside,
        shared with the composed path, so the §3.3 row-level undo
        manifest is unchanged.  Paging arrays and MoERuntime tables ride
        in as data: recovery edits change nothing that is launched.  MLA
        attends over its latent pool (K = V) with the absorbed query and
        reads out through ``w_post``."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.attention_type == "mla":
            q, token = A.mla_decode_q_token(p["mixer"], cfg, h, page)
            A.mla_write_token(pools, page, token)
            k_pool = v_pool = pools["ckr"]
            q = q.to(k_pool.dtype)
        else:
            q, k, v = A.gqa_decode_qkv(p["mixer"], cfg, h, page)
            A.gqa_write_token(pools, page, k, v)
            k_pool, v_pool = pools["k"], pools["v"]
            w_post = p["mixer"]["wo"]
        moe_p = p["moe"]
        shared = moe_p.get("shared")
        y, _ = ops.decode_megastep(
            q, k_pool, v_pool, page["tables"], page["seq_lens"],
            page["starts"], x, w_post, p["ln2"], moe_p["router"],
            runtime.logical_to_physical, runtime.replica_count,
            runtime.expert_mask, moe_p["gate"], moe_p["up"], moe_p["down"],
            self.expert_offset, shared["w_gate"] if shared else None,
            shared["w_up"] if shared else None,
            shared["w_down"] if shared else None,
            top_k=cfg.moe.top_k, cap=cap,
            e_local=MoE.physical_experts(cfg.moe), eps=cfg.norm_eps)
        return y

    # -- ring cache (the ring serve step) ---------------------------------------

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None, device=None):
        """An empty ring cache: per layer group the (L, batch, W, ...)
        rings of :func:`attention.gqa_init_cache` (MLA: the latent ring),
        the (L, batch, ...) Mamba states, a hybrid group's ``{"attn":
        rings, "ssm": (L, n_mamba, batch, ...) states}``, the audio
        decoder's ``{"self": rings, "cross": {"k", "v"}: (L, batch,
        encoder_seq, Hkv, Dh)}``; and ``pos`` (batch,) int32 zeros."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        device = self.device if device is None else device
        init = (A.mla_init_cache if cfg.attention_type == "mla"
                else A.gqa_init_cache)
        caches: Dict[str, Any] = {}
        for name, n, mixer, _, cross in self.layer_groups():
            if name == "enc_layers":
                continue
            if mixer == "hybrid":
                n_mamba = sum(mx == "mamba"
                              for _, mx, _ in self.period_sublayers())
                caches[name] = {
                    "attn": A.gqa_init_cache(cfg, batch, max_seq, dtype,
                                             device, (n,)),
                    "ssm": M.mamba_init_state(cfg, batch, dtype, device,
                                              (n, n_mamba))}
            elif mixer == "mamba":
                caches[name] = M.mamba_init_state(cfg, batch, dtype, device,
                                                  (n,))
            else:
                caches[name] = init(cfg, batch, max_seq, dtype, device, (n,))
            if cross:
                shape = (n, batch, cfg.encoder_seq, cfg.num_kv_heads,
                         cfg.resolved_head_dim())
                caches[name] = {"self": caches[name], "cross": {
                    key: torch.zeros(shape, dtype=dtype, device=device)
                    for key in ("k", "v")}}
        caches["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
        return caches

    @torch.no_grad()
    def decode_step(self, params, cache, token, runtime=None):
        """One decode step against the ring cache: token (B,) int at each
        row's position ``cache["pos"]``.  Every ring and Mamba state is
        updated in place and ``cache["pos"]`` advances by one.  Returns
        ``(logits, cache)``."""
        cfg = self.cfg
        runtime = runtime if runtime is not None else self.default_runtime()
        pos = cache["pos"]
        x = params["embed"][token.long()]                # (B, D)
        cap = self._cap(x.shape[0])
        block = functools.partial(self._block_decode, pos=pos,
                                  runtime=runtime, cap=cap)
        for name, n, mixer, ffn_kind, cross in self.layer_groups():
            if name == "enc_layers":
                continue
            if mixer == "hybrid":
                rates = self._period_rates(params, name)
                for i in range(n):
                    x = self._period_decode(
                        take_layer(params[name], i), x,
                        take_layer(cache[name], i), rates, i, block)
                continue
            rates = self.ssm_rates(params, name) if mixer == "mamba" else None
            for i in range(n):
                x = block(take_layer(params[name], i), x,
                          take_layer(cache[name], i), mixer=mixer,
                          ffn_kind=ffn_kind, cross=cross,
                          ssm_A=None if rates is None else rates[i])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache["pos"] = pos + 1
        return x @ params["lm_head"], cache

    def _block_decode(self, p, x, csl, *, pos, runtime, cap, mixer,
                      ffn_kind, cross=False, ssm_A=None):
        """One block's ring decode step at positions ``pos``.  ``csl``:
        the layer's ring (or Mamba state; ``ssm_A`` its scan rates), an
        audio decoder layer's ``{"self": ring, "cross": {"k", "v"}}``."""
        cfg = self.cfg
        self_csl = csl["self"] if cross else csl
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            x = x + M.mamba_decode(p["mixer"], cfg, h, self_csl, A=ssm_A)
        else:
            decode = (A.mla_decode if cfg.attention_type == "mla"
                      else A.gqa_decode)
            x = x + decode(p["mixer"], cfg, h, self_csl, pos)
        if cross:
            hc = rms_norm(x, p["ln_cross"], cfg.norm_eps)
            x = x + A.gqa_cross_decode(p["cross"], cfg, hc,
                                       csl["cross"]["k"], csl["cross"]["v"])
        return self._ffn(p, x, ffn_kind, runtime, cap)


def _stack(entries):
    """Stack a list of equally nested cache entries on a new leading
    axis, leaf by leaf."""
    if isinstance(entries[0], dict):
        return {key: _stack([e[key] for e in entries]) for key in entries[0]}
    return torch.stack(entries)


def _ring_from_full(rows, positions, window: int, max_seq: int):
    """Arrange a whole prompt's (B, S, ...) cache rows (GQA's ``k`` and
    ``v``, MLA's ``ckr``) into rings of W = min(window or max_seq,
    max_seq) slots a row: position p in slot p % W, the last W positions
    where S > W."""
    S = positions.shape[0]
    W = min(window or max_seq, max_seq)
    first = max(S - W, 0)
    slots = (positions[first:] % W).long()
    rings = {}
    for key, t in rows.items():
        ring = t.new_zeros((t.shape[0], W) + tuple(t.shape[2:]))
        ring[:, slots] = t[:, first:]
        rings[key] = ring
    return rings
