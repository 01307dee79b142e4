#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases device,build,kernels   # a subset
    python3 chip_smoke.py --layers 24     # the qwen paths' depth
    python3 chip_smoke.py --paths ssm     # serve one engine path
    python3 chip_smoke.py --paths hybrid  # one Jamba period
    python3 chip_smoke.py --paths disagg  # the role switch
    python3 chip_smoke.py --paths composed,http,dense  # the launcher's
                                          # HTTP drill; internlm2-20b
    python3 chip_smoke.py --paths composed,fleet  # revive, spare, restart
    python3 chip_smoke.py --paths vlm,audio  # the ring serve step
    python3 chip_smoke.py --paths train,examples  # training; the twins
    python3 chip_smoke.py --paths train_ssm  # Mamba and hybrid training
    python3 chip_smoke.py --paths dist    # the distributed MoE layer
    python3 chip_smoke.py --paths dryrun  # the dry run held to the card
    python3 chip_smoke.py --paths train,tp  # tensor-parallel serve and
                                            # train steps
    python3 chip_smoke.py --paths mla_composed,mla_megakernel,mla_serial
    python3 chip_smoke.py --profile       # + where the device time goes

Phases, in order; any failure raises and the script exits non-zero:

1. device  — require CUDA, print the card's name and power limit, turn
             TF32 off for matmuls and cuDNN.
2. build   — compile the ten CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
             parallel) into ``build/kernels``.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the slice's shapes, in f32 and bf16: paged attention (a
             windowed case, an idle row, the engine's full context of 512
             positions at B = 8 and 40, one 4090-position row over 64
             splits, windows that start mid-split or leave whole splits
             empty) and the fused MoE (masked / lost /
             over-capacity / foreign / empty experts); router top-k
             (well-separated logits, ties, masked columns); the decode
             megastep at full width, decode (B=8) and chunk (B=40) rows,
             with a window, an idle row, masked and lost experts, a dead
             replica, an over-capacity expert and a foreign half bank,
             its slot tables exactly those of the plain sort pass; the
             grouped expert FFN over the dense capacity buffer at decode
             (C=8) and prefill (C=20, 40) capacity; whole-prompt attention
             at S = 16, 200, 256 and 512, with and without window 6; the
             selective scan at falcon-mamba-7b's width (d_inner 8192, N
             16), a prefill row at S = 200, 256, 512 and 2048 and the
             decode step of 8 slots from their state, also in the
             engine's in-place mode (the bf16 state written where it
             lies, its storage unchanged).  Then the same at
             deepseek-v3's shapes: paged attention at the latent layout
             (Hkv = 1, G = 128, Da = 576, one pool as K and V) at decode
             B = 8 and chunk B = 40 over the engine's context, over one
             4090-position row and windowed with an idle row; the
             megastep at that layout (w_post (73728, 7168), 256 + 32
             experts, top-8) at B = 8 and 40 with masked and lost
             experts and a dead replica, its route stage timed beside
             softmax + topk over the same logits; whole-prompt attention with
             Dq = 192, Dv = 128, H = 128 at S = 256 and 512 with and
             without window 6; the fused MoE at T = 8 and 40 and the
             expert FFN at C = 8, 9, 18 over 288 experts of D = 7168, F
             = 2048 (f32 over a third of the bank).  Then the dense
             family's layouts: paged attention at internlm2-20b's GQA (H
             48 over Hkv 8: G = 6, Dh 128) and minicpm3-4b's latent layout
             (Hkv 1, G 40, Da 288, K = V: the wide kernel) at B = 8 and
             40, and whole-prompt attention at internlm2-20b's widths at
             S = 200 and 256, with and without window 6.  Then the
             hybrid path's layouts (jamba-1.5-large-398b): paged
             attention at H 64 over Hkv 8 (G = 8), Dh 128, decode B = 8;
             whole-prompt attention at those heads, S = 200 and 256; the
             scan at d_inner 16384 (prefill S = 200, 256; the decode
             step, also in place); the fused MoE at D 8192, F 24576
             over 4 experts, top-2, at T = 8 (cap 8) and T = 256 (cap
             160).  Then the ring serve step's layouts
             (internvl2-26b, seamless-m4t-large-v2; B = 4): whole-prompt
             attention not causal over keys of another length (the
             audio encoder, S 1536, H = Hkv = 16, Dh 64; the cross
             prefill, 16 queries over the 1536 frames) and causal over
             internvl2-26b's 256 patches + 64 tokens (H 48, Hkv 8, Dh
             128); paged attention over a ring viewed as a pool of one
             block a row, at internvl2-26b's G = 6 over W 384,
             seamless's G = 1, Dh 64 over W 128 and its cross decode
             over 1536 frames.  Every
             kernel runs twice and must be bitwise equal; kernel and plain
             version are timed at the main path's shapes (the fused MoE at
             T = 8 and 40 with its device time split between its kernels
             and its sort pass, the megastep at B = 8 and 40 also beside
             the composed chain of the same block), and beside a library
             call where one computes the same function.  Last the
             three backward kernels (new in the port) against their
             written-out plain versions, f32 and bf16, each twice and
             bitwise equal: flash_prefill_bwd at qwen2-moe-a2.7b's
             training shape (B 4, S 256, H = Hkv = 16, Dh 128, causal),
             with window 6, at internlm2-20b's G = 6 and at MLA's Dq 192
             / Dv 128 (H 128); expert_ffn_bwd over the training step's
             capacity buffer (E 64, C 80, D 2048, F 1408) with empty
             rows; timed beside ``torch.autograd.grad`` through
             ``scaled_dot_product_attention`` and the bmm chain;
             ssm_scan_bwd at falcon-mamba-7b's training shape (B 4, S
             256, d_inner 8192, N 16), at S 200 with h_final's gradient
             and at Jamba's d_inner 16384, timed beside its bound and
             plain version (no library call computes it).
4. model   — qwen2-moe-a2.7b at full width, 2 layers, f32: one chunk step
             and one decode step on the card against the same weights on
             the CPU (plain versions), once per decode implementation
             (composed, megakernel), and one whole-prompt prefill
             (dense-scatter MoE) installed into the pools, then a decode
             step; logits and installed K/V rows within tolerance, greedy
             tokens equal, and the two implementations agree on the card.
             The same for deepseek-v3 at full width (MLA, 1 dense + 1 MoE
             layer, its bank cut to 16 + 4 experts with top-8 kept: a
             288-expert f32 layer is 50.7 GB), its prefill installed into
             the latent pools.  Then falcon-mamba-7b at full width, 2
             layers, f32: a
             whole-prompt prefill at bucket 256, its state installed, two
             decode steps; logits and state within tolerance, greedy
             tokens equal.  Then one period of jamba-1.5-large-398b at
             full width, f32, weights drawn on the card, its bank cut to
             2 + 0 experts (top-2 kept) for this check alone: a
             whole-prompt prefill at bucket 256 installed into slot 2
             (pool rows and seven Mamba states), two decode steps, the
             fused MoE; the same checks.  Then the dense family at full width, 2
             layers, f32, weights drawn on the card: internlm2-20b (GQA,
             G = 6) and minicpm3-4b (MLA, latent 256 + 32), a chunk step,
             a decode step and the whole-prompt prefill each.  Then the
             ring serve step (``Model.prefill`` into per-row rings, 4
             ``decode_step``s) of every registered arch at its smoke
             config, and of internvl2-26b and seamless-m4t-large-v2 at
             full width, 2 layers (the audio's 2 encoder layers over
             1536 frames), f32: logits within tolerance, greedy tokens
             equal, the attention, scan and expert kernels launched as
             often as the layers say.
5. engine  — behind the ``InferenceEngine`` (2 DP ranks, collocated but
             on ``disagg``), in bf16.  Each group of paths below shares
             one workdir: its first build writes ``weights.npz`` (no
             per-rank shard file), the others load it, and it is removed
             before the next group writes its own (a run may write at
             most 45 GiB to its disk).  Three qwen paths, qwen2-moe-a2.7b
             at full width cut to 6 of its 24 layers (``--layers``; ~1.2
             GB of checkpoint a layer plus 1.3 GB, read whole by each of
             their six builds): chunked admission with the fused MoE and
             each decode implementation (composed, megakernel), and serial
             admission (whole-prompt prefills) with the model's
             dense-scatter MoE.  Then the same three paths for deepseek-v3
             (``mla_composed``, ``mla_megakernel``, ``mla_serial``) at full
             width, depth cut from 61 to 1 of its 3 dense layers + 1 MoE
             layer (a ~31 GB ``weights.npz``).  Then the ``ssm`` path:
             falcon-mamba-7b at full width cut to 16 of its 64 layers (no
             shards), whose chunked admission falls back to whole-prompt
             installs.  Then the ``hybrid`` path: one period (8 sublayers) of
             jamba-1.5-large-398b at full width, its bank cut from 16 +
             16 to 4 + 0 experts a MoE sublayer with top-2 kept (a 32.5
             GB ``weights.npz``), the fused MoE, whole-prompt installs of
             pool rows and seven Mamba states; its fault ``attn+moe``
             masks logicals 2-3.  Each of these serves 8
             requests without a fault, then the same workload with an L6
             fault on physical 1 mid-step at the run's step 6
             (``attn+moe`` on the MoE paths, ``attn`` on the ssm path),
             revived in place, on a second build; the paths whose
             whole-prompt installs bypass the prefix cache (``serial``,
             ``mla_serial``, ``ssm``, ``hybrid``), and ``mla_composed``
             and ``mla_megakernel``, serve it on the first engine once
             the clean run has drained and its parked prefix-cache
             blocks are dropped, so it admits as a fresh engine would.
             The ``dense`` path serves internlm2-20b at full width (d_model
             6144, vocab 92544) cut to 8 of its 48 layers (~8.5 GB of
             ``weights.npz``) on the composed chunked path the same way,
             its fault ``attn`` (no experts), revived by migration.  The
             ``disagg`` path: qwen2-moe-a2.7b at full width in the qwen
             group (its depth and weights.npz) in disaggregated
             mode, 2 attention ranks (physicals 0-1) and 2 expert ranks
             (physicals 2-3), the same 8 requests three times: without a
             fault; with an L6 ``moe`` fault mid-step on physical 2 (EP
             rank 0) one step after the first run had every request past
             its prefill, revived by the §3.4 role switch (the donor's
             residents KV-streamed, each install held ``torch.equal`` to
             its payload on the card; EP rank 0's experts read back from
             ``weights.npz``, its checksum equal to start-up's; no more
             prefill tokens than the first run); and with the same fault
             under ``background_role_switch`` (logicals 4-31 masked until
             the switch finishes at the next step, 32 experts restored,
             the mask cleared), after which that engine restarts in
             place (``full_reinit``, timed: the restart baseline; the
             card's memory after it within 5% of before the
             fault, no second copy of the weights at the peak, the
             rebuilt decode graph ``cached``).  The ``fleet`` path runs
             in the 6-layer qwen group: ``repro_torch.fleet.build_fleet``
             of 2 instances and 1 spare of the composed engine serves the
             8 prompts twice over; instance 0's redundant slots are
             rebalanced from its routing; then three L6 faults, each a
             forced decision of the arbiter: a revive on instance 0
             ("precompiled"; the device then rejoins, its EP rank read
             back following the map, its checksum equal to before the
             fault), a spare for instance 1 (its reachable residents'
             KV streamed, each install ``torch.equal`` to its payload),
             a restart of that spare (``full_reinit``, checked as above);
             it prints each policy's stall, the arbiter's un-forced
             estimates, tokens/s, TTFT p50/p99 and the greedy tokens each
             request shares with the composed path's fault-free run.
             Last in that group the ``http`` path: the launcher
             (``python -m repro_torch.launch.serve --fleet 2 --mode
             collocated --overlap --http 0 --config full --layers 6
             --device cuda``, the group's workdir, so both instances load
             its weights.npz) in a child process, drilled by
             ``scripts/http_smoke_torch.py``: 48 tokens streamed over SSE
             through a device fault sent to ``/control`` after 6 of them
             and revived in place (the arbiter unforced), the revive
             decision in ``/instances``, ``/health`` degraded and then
             healthy after ``planned_restart``; it prints the client's
             seconds to boot, TTFT over HTTP, the largest gap between SSE
             chunks, the revive's Table-1 seconds and the seconds from the
             restart to healthy.  Its launches are not counted (another
             process).  The ``vlm`` and ``audio`` paths build no engine
             (the paged engine serves neither family, in the port as in
             the JAX package): the ring serve step of internvl2-26b at
             full width cut to 8 of its 48 layers and of
             seamless-m4t-large-v2 at full width and depth (24 encoder
             + 24 decoder layers), in bf16, weights from ``Model.init``
             on the card: 4 rows (256 seeded patches and 16-64 text
             tokens, rings of 384; 1536 seeded frames and 8-16 text
             tokens, rings of 128), a prefill and 32 greedy decode
             steps, timed (the audio's encoder and cross K/V alone
             too), then the same fed the same tokens through the plain
             attention versions on the card, each step's logits within
             RING_LOGIT_RTOL.  The ``train`` path builds no engine:
             ``train_loop.train`` of qwen2-moe-a2.7b at full width cut
             to 2 layers (~1.83 B parameters) in f32 on the card, 3
             steps of 4 x 256 tokens from ``Model.init(seed)`` at
             AdamW's lr 3e-4 after a one-step warmup, through
             flash_prefill, expert_ffn and their backward kernels; then
             the same steps from the same params through the plain
             versions and the written-out plain backward on the card,
             every step's loss, ce, aux and grad_norm within 1e-3, and
             step 0's gradient of every leaf within 1e-3 of the leaf's
             scale; it prints the step seconds, training tokens/s, the
             peak card memory and the final params' largest relative
             difference,
             then runs ``python -m repro_torch.launch.train`` (the same
             model, 3 steps) in a child process.  The ``train_ssm`` path
             does the same for falcon-mamba-7b at full width cut to 4 of
             its 64 layers (0.958 B parameters), through ssm_scan and
             its backward kernel (a launch of each a layer and step),
             its launcher ``--arch falcon-mamba-7b --layers 4``, and then
             for the smoke jamba-1.5-large-398b period, whose attention,
             seven Mamba and four gather_psum MoE sublayers run all three
             backward kernels in one model.  The ``examples`` path
             runs the four ``examples/*_torch.py`` twins with ``--device
             cuda`` in child processes at once; each must exit 0 with
             its OK line (``train_moe_torch.py`` after its own "did not
             learn" assertion, 300 steps).  The ``dist`` path builds no
             engine: the distributed MoE layer
             (``repro_torch.distributed``) on a world of one under NCCL,
             qwen2-moe-a2.7b at full width, 2 layers, bf16, weights from
             ``Model.init`` on the card; for each of ``gather_psum``,
             ``gather_psum_fused``, ``a2a`` and ``a2a_fused``,
             ``logits_full`` over 4 x 256 tokens, the ring prefill and 16
             decode steps, with ``moe_dist`` and without it, fed the same
             tokens: ``gather_psum_fused`` bitwise equal to the local
             fused path, ``gather_psum`` and ``a2a`` within tolerance,
             every MoE layer of each impl within tolerance of the local
             layer on the same inputs, ``moe_fused`` or ``expert_ffn``
             launched once a layer and call; it prints the NCCL set-up's
             seconds, each run's seconds and each collective's host and
             device time in one decode step (torch.profiler).  The
             ``dryrun`` path builds no engine: two child processes run
             the port's dry run (``python -m repro_torch.launch.dryrun
             --arch qwen2-moe-a2.7b --shape decode_32k``, then with
             ``--multi-pod --no-extrapolate``), each record holding the
             JAX package's keys and the argument bytes that the port's
             ShardingRules place; meanwhile qwen2-moe-a2.7b at full
             width, 2 layers, bf16, one rank (the dist path's weights
             when it ran first): a ring prefill of 4 x 2048 tokens and
             one decode step, each traced by ``launch.dryrun.trace`` on
             fake copies of its arguments and run on the card (a
             warm-up call, then a timed one), the trace's argument bytes
             equal to the bytes the card's arguments hold; it prints the
             trace's temp bytes beside the card's peak above the
             arguments, and the trace's FLOPs and bytes over the card's
             time as rates against the data sheet
             (``repro_torch/hardware.py``).  The ``tp`` path builds no
             engine: the tensor-parallel serve steps
             (``Model(tp=TensorParallel(...))``) on a world of one under
             NCCL (the dist path's group and weights when it ran
             first): qwen2-moe-a2.7b at full width, 2 layers, bf16, a
             ring prefill of 4 x 2048 tokens and 8 decode steps, and
             minicpm3-4b at full width, 2 layers (its latent ring
             split over the window, so its decode writes
             ``paged_attention``'s ``lse_out`` and merges), each bitwise
             equal to the same model without tp, greedy tokens equal,
             step times and launches printed; then the kernels at a
             rank's shapes of the production mesh's 'model' = 16 (16
             simulated ranks one after the other): ``flash_prefill``
             at qwen's 1 head and deepseek-v3's 8 heads a rank,
             ``ssm_scan`` at falcon-mamba-7b's 512 of 8192 channels, a
             head-parallel ``paged_attention`` at qwen's 1 KV head over
             a 2048-slot ring, and the context-parallel decode of
             internlm2-20b's GQA (G 6) and deepseek-v3's latent (G 128)
             over 16 slices of 128 slots: each slice's f32 o within
             1e-5 (4e-3 for the latent kernel, which rounds P to bf16)
             of the plain version in f32 and its lse within 1e-3, the
             slices merged on the card within the same limit of the
             plain whole-ring call and of the kernel's (a merge
             dropping a rank's slice or ignoring the lse shown to miss
             by more), a short
             row's empty slices -inf with zeros; timed at a slice whose
             every row is full.  Between the two halves the tp path
             trains: the train path's qwen2-moe-a2.7b (2 full-width
             layers, f32, its weights and 4 x 256-token batches) for 2
             steps with ``Model(tp=...)`` and ``cfg.remat`` on the world
             of one, against 2 steps of the kernel trainer without
             them: bitwise, or (naming the first piece that differs)
             the losses within 1e-6 relative and step 0's gradients
             within 1e-5 of each leaf's scale; the params' largest
             difference, both runs' peak memory and the tp run's
             ``flash_prefill_bwd`` and ``expert_ffn_bwd`` launches
             printed and checked.  After them the backward kernels at
             a 16-way rank's shapes in f32: ``flash_prefill_bwd`` at
             qwen's 1 head and deepseek-v3's 8, ``expert_ffn_bwd`` over
             4 expert slots, ``ssm_scan_bwd`` at 512 of 8192 channels,
             each held to its plain version and timed beside its bound
             and the library's backward.  Each path's kernels' launch counts are read from
             its faulted run (``disagg``: the synchronous switch's;
             ``fleet``: the whole fleet run), counted from 0 just before
             it.  Each engine build
             prints its start-up files, its memory on the card and the
             host's MemTotal and MemAvailable.
6. a ``{"kernels": [...]}`` line (each kernel's row at the qwen or
   falcon shapes, the backward kernels' at the train paths' in f32 with
   their bf16 row under ``bf16``, with its deepseek-v3 rows under ``mla``, the dense
   family's under ``dense``, Jamba's under ``hybrid``, the ring serve
   step's under ``ring`` and the tp path's rank-shaped calls under
   ``tp``; its launches
   summed over the paths and per path), then the ``{"ok": true, ...}``
   line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "model", "engine")
# the H100 SXM data sheet's memory rate and peaks, read from
# ``repro_torch.hardware`` once the port is imported (main)
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
KERNEL_META = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:82"),
    "moe_fused": ("src/repro_torch/kernels/csrc/moe_fused.cu",
                  "src/repro/kernels/moe_fused.py:122"),
    "decode_megastep": ("src/repro_torch/kernels/csrc/decode_megastep.cu",
                        "src/repro/kernels/decode_megakernel.py:349"),
    "router_topk": ("src/repro_torch/kernels/csrc/router_topk.cu",
                    "src/repro/kernels/router_topk.py:53"),
    "expert_ffn": ("src/repro_torch/kernels/csrc/expert_ffn.cu",
                   "src/repro/kernels/expert_ffn.py:41"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:83"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:52"),
    # new in the port: repro has no Pallas backward, and differentiates
    # the jnp functions these kernels' gradients replace
    "flash_prefill_bwd": ("src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
                          "src/repro/models/attention.py:78"),
    "expert_ffn_bwd": ("src/repro_torch/kernels/csrc/expert_ffn_bwd.cu",
                       "src/repro/models/moe.py:163"),
    "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     "src/repro/models/mamba.py:90"),
}
# the engine paths each kernel runs on; its launches are counted there
# (the megakernel paths run paged_attention too: MLA's first-k dense
# layers keep the composed chain)
KERNEL_PATH = {"paged_attention": ("composed", "serial", "mla_composed",
                                   "mla_megakernel", "mla_serial", "disagg",
                                   "fleet", "spec", "overlap", "dense",
                                   "hybrid", "vlm", "audio", "dist",
                                   "dryrun", "tp"),
               "moe_fused": ("composed", "mla_composed", "disagg", "fleet",
                             "spec", "overlap", "hybrid", "dist"),
               "decode_megastep": ("megakernel", "mla_megakernel",
                                   "spec_megakernel"),
               "router_topk": ("megakernel", "mla_megakernel",
                               "spec_megakernel"),
               "expert_ffn": ("serial", "mla_serial", "train", "dist",
                              "dryrun", "tp"),
               "flash_prefill": ("serial", "mla_serial", "hybrid", "vlm",
                                 "audio", "train", "dist", "dryrun", "tp"),
               "ssm_scan": ("ssm", "hybrid", "train_ssm"),
               "flash_prefill_bwd": ("train", "tp"),
               "expert_ffn_bwd": ("train", "tp"),
               "ssm_scan_bwd": ("train_ssm",)}
IMPLS = ("composed", "megakernel")
# the engine paths: EngineConfig options of each.  ``ssm`` serves
# falcon-mamba-7b, whose chunked admission falls back to whole-prompt
# installs (a Mamba mixer cannot chunk); the ``mla_*`` paths deepseek-v3
# (multi-head latent attention); the others qwen2-moe-a2.7b, ``disagg`` in
# disaggregated mode (2 attention ranks, 2 expert ranks), ``fleet`` as a
# fleet of such engines (``repro_torch.fleet``: 2 instances and a spare),
# ``spec`` and ``spec_megakernel`` with self-speculative decode (windows
# of up to 6 rows verified in the chunk launch), ``overlap`` with the
# overlap pipeline (step N+1 launched before step N drains); ``dense``
# serves internlm2-20b (no experts); ``http`` is the launcher
# (``python -m repro_torch.launch.serve``) in a child process, a fleet of
# 2 such engines with the overlap pipeline behind the HTTP front end,
# drilled by ``scripts/http_smoke_torch.py``; ``hybrid`` serves one
# period of jamba-1.5-large-398b (attention and seven Mamba sublayers,
# the fused MoE on four), whose chunked admission falls back to
# whole-prompt installs.  ``vlm`` (internvl2-26b) and ``audio``
# (seamless-m4t-large-v2) build no engine: the paged engine serves
# neither, in the port as in the JAX package, so they drive the model's
# ring serve step (``Model.prefill``, ``decode_step``; RING_PATHS).
# ``train`` builds no engine either: ``train_loop.train`` of qwen2-moe-
# a2.7b at full width, TRAIN_LAYERS deep, in f32, then the launcher
# (``python -m repro_torch.launch.train``) in a child process;
# ``examples`` runs the four ``examples/*_torch.py`` twins on the card,
# each in a child process.  ``train_ssm`` is ``train`` for the Mamba
# family: falcon-mamba-7b at full width, TRAIN_SSM_LAYERS deep, then the
# smoke jamba-1.5-large-398b period through all three backward kernels.
PATHS = {"composed": dict(moe_impl="fused", decode_impl="composed"),
         "megakernel": dict(moe_impl="fused", decode_impl="megakernel"),
         "serial": dict(admission="serial", decode_impl="composed"),
         "mla_composed": dict(moe_impl="fused", decode_impl="composed"),
         "mla_megakernel": dict(moe_impl="fused", decode_impl="megakernel"),
         "mla_serial": dict(admission="serial", decode_impl="composed"),
         "ssm": dict(),
         "disagg": dict(mode="disaggregated", num_moe=2, moe_impl="fused",
                        decode_impl="composed"),
         "fleet": dict(moe_impl="fused", decode_impl="composed"),
         "spec": dict(moe_impl="fused", decode_impl="composed",
                      spec_window=6),
         "spec_megakernel": dict(moe_impl="fused", decode_impl="megakernel",
                                 spec_window=6),
         "overlap": dict(moe_impl="fused", decode_impl="composed",
                         overlap=True),
         "dense": dict(decode_impl="composed"),
         "http": dict(mode="collocated", overlap=True),
         "hybrid": dict(moe_impl="fused", decode_impl="composed"),
         "vlm": dict(), "audio": dict(), "train": dict(), "examples": dict(),
         "dist": dict(), "dryrun": dict(), "tp": dict(),
         "train_ssm": dict()}
QWEN_ARCH = "qwen2-moe-a2.7b"
DENSE_ARCHS = ("internlm2-20b", "minicpm3-4b")
PATH_ARCH = {"ssm": "falcon-mamba-7b", "mla_composed": "deepseek-v3",
             "mla_megakernel": "deepseek-v3", "mla_serial": "deepseek-v3",
             "dense": "internlm2-20b", "hybrid": "jamba-1.5-large-398b",
             "vlm": "internvl2-26b", "audio": "seamless-m4t-large-v2",
             "train_ssm": "falcon-mamba-7b"}
# card-vs-plain tolerances (allclose: |got - want| <= atol + rtol |want|).
# f32: both accumulate in f32 in different orders.  bf16: the plain
# versions round intermediates to bf16 where the kernels keep f32 (the
# attention probabilities before p @ V; the expert outputs and each of
# the k weighted adds), a few bf16 ulps at |y| ~ 1.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
# the megastep chains attention and eight products; f32 as
# tests/test_decode_megakernel.py, bf16 as above
MEGA_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 3e-2)}
ROUTER_RTOL = 2e-5            # weights; indices must be equal
# tests/test_kernels.py's tolerances for the two kernels of the serial path
FFN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
# the selective scan (atol, rtol): tests/test_kernels.py:89's f32
# tolerance for both types, since both versions cast the bf16 inputs to
# f32 before any product and then compute the same sums in f32
SSM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 1e-4)}
MODEL_LOGIT_ATOL = 1e-3       # f32, 2 layers at full width, card vs CPU
# the f32 Mamba state after a whole prompt, card vs CPU (atol, rtol): the
# products before the scan sum in other orders
STATE_TOL = (1e-4, 1e-3)
ENGINE_LAYERS = 24            # qwen2-moe-a2.7b's full depth
# the depth of the qwen paths (``--layers``): every engine build reads its
# whole weights.npz (~1.2 GB a layer) and these paths build six (~250 s
# at 24 layers on the H100's host), so they run cut to keep the script
# well inside its 1200 s limit.  ``disagg`` ran all 24 layers in its own
# workdir until the dense and http paths came (~180 s of its ~1020 s run
# went to its three 24-layer builds, a 30 GB start-up write and a 24-layer
# restart); it now shares the qwen group's depth and weights.npz.  The
# group ran 8 layers from PR 20 until the ring paths came (that whole run
# took 1,137 s of the limit on the H100's host); 6 keep the margin.  4
# saved too little for what they cost (the group's first seven paths took
# 130.5 s against 153.4 s at 6 on the same host), and there the overlap
# path's f32 greedy speculation accepted no draft, which its check needs.
# The paths named here keep their own depth (and workdir)
COLLOCATED_LAYERS = 6
# deepseek-v3's engine paths: 1 of its 3 first-k dense layers and 1 MoE
# layer, whose experts alone are 25.4 GB of bf16; the two dense layers
# cut are 2.3 GB of the weights.npz that the group writes once and its
# three builds read (~1 GB/s on the H100's host)
MLA_DENSE_LAYERS = 1
# internlm2-20b cut from 48 layers: ~0.78 GB of bf16 a layer plus 2.3 GB
# of embedding and head, ~8.5 GB of weights.npz at 8
DENSE_LAYERS = 8
# falcon-mamba-7b cut from 64 layers (~0.23 GB of bf16 a layer) to make
# room for the hybrid path, which runs the same scan at twice its width
SSM_LAYERS = 16
# jamba-1.5-large-398b: one period of its 72 layers (8 sublayers)
HYBRID_LAYERS = 8
# internvl2-26b cut from 48 layers as internlm2-20b (its backbone)
VLM_LAYERS = 8
# seamless-m4t-large-v2 at its full 24 decoder (and 24 encoder) layers:
# ~2.3 B parameters, 4.6 GB in bf16
AUDIO_LAYERS = 24
# qwen2-moe-a2.7b cut to 2 of 24 layers for the train path: ~1.83 B
# parameters, whose f32 params, grads and AdamW moments are ~29 GB (the
# examples path shares its group: the twins run smoke configs)
TRAIN_LAYERS = 2
# falcon-mamba-7b cut to 4 of 64 layers for the train_ssm path: 0.958 B
# parameters, ~15.3 GB in f32 with grads and AdamW moments
TRAIN_SSM_LAYERS = 4
PATH_LAYERS = {"dense": DENSE_LAYERS, "ssm": SSM_LAYERS,
               "hybrid": HYBRID_LAYERS, "vlm": VLM_LAYERS,
               "audio": AUDIO_LAYERS, "train": TRAIN_LAYERS,
               "examples": TRAIN_LAYERS, "dist": TRAIN_LAYERS,
               "dryrun": TRAIN_LAYERS, "tp": TRAIN_LAYERS,
               "train_ssm": TRAIN_SSM_LAYERS}
# the ring paths' workloads: rows, each row's text tokens (drawn from
# the range), the rings' slots (max_seq); each row feeds 32 greedy tokens
# through 32 decode steps
RING_PATHS = {"vlm": dict(rows=4, text=(16, 64), max_seq=384),
              "audio": dict(rows=4, text=(8, 16), max_seq=128)}
RING_NEW_TOKENS = 32
# the ring paths' bf16 logits, kernels against the plain versions on the
# card, each step fed the same tokens: |d| <= RTOL * (max |plain| +
# |plain|), TOL["bfloat16"]'s 3e-2 against the step's logit scale, since
# the two round the attention's probabilities at different places (the
# plain versions to bf16, paged_attention's GQA kernel keeps f32) through
# 8 (vlm) or 48 (audio) layers
RING_LOGIT_RTOL = 3e-2
# the hybrid path's bank: 4 + 0 experts a MoE sublayer (top-2 kept), as
# the config's 16 + 16 are 38.65 GB a sublayer in bf16
HYBRID_EXPERTS = 4
# paths whose faulted run is served on the clean run's engine once that
# has drained, instead of on a second build, to keep the script inside
# its time limit: the builds it saves read the hybrid's 32.5 GB and
# deepseek-v3's 33 GB weights.npz again (~27 and ~29-33 s each on the
# H100's host).  The clean run's parked prefix-cache blocks are dropped
# first (``BlockManager.drop_cached``), so the faulted run admits and
# prefills as a fresh engine's would: the whole-prompt installs of
# serial, mla_serial, ssm and hybrid bypass the prefix cache anyway, and
# the mla_composed and mla_megakernel runs chunk and hit it only within
# the run.  ``composed`` keeps its second build: the overlap path holds
# its faulted streams as a fresh engine's
FAULT_ON_SAME_ENGINE = ("serial", "mla_serial", "ssm", "hybrid",
                        "mla_composed", "mla_megakernel")
# the kernels phase's shapes: the engine phase's batch, chunk and paging,
# qwen2-moe-a2.7b's widths
SHAPES = dict(max_batch=8, chunk=32, block_size=16, num_blocks=256,
              max_blk=512 // 16, d_model=2048, d_ff=1408, top_k=4, cap=8)


# time_ms: a call slower than this, in ms, is timed over SLOW_REPS calls
SLOW_CALL_MS, SLOW_REPS = 10.0, 5


def log(msg: str) -> None:
    print(msg, flush=True)


# -- helpers ------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of one call, each call after a 128 MB write that
    evicts the 50 MB L2 (the serving path finds its operands cold).  A
    ~2 ms device sleep ahead of each call keeps the stream busy while the
    host enqueues it, so the events time the device work, not the host's
    launch overhead (``fn`` must not synchronise).  A call slower than
    SLOW_CALL_MS on its second warm-up (mostly a plain version's) is
    timed over SLOW_REPS calls: 28 calls of each 60 ms plain version
    cost the kernels phase ~20 s of the time limit."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    if a.elapsed_time(b) > SLOW_CALL_MS:
        reps = min(reps, SLOW_REPS)
    else:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times]))


def laps(phase: str):
    """A function that logs, under a name, the seconds since its last call
    (or since this one): where a phase's share of the time limit goes."""
    last = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"  [{phase} {what}: {now - last[0]:.1f} s]")
        last[0] = now
    return lap


def kernel_breakdown(torch, fn, reps: int = 20):
    """Mean device time of each kernel ``fn`` launches, in µs, largest
    first (``fn`` must not synchronise)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / reps, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)


def kernel_sequence(torch, fn):
    """The kernels of one call of ``fn``, in launch order, each with its
    device time in µs (after a warm-up call; ``fn`` must not
    synchronise): where a chain's stages that share a kernel name go."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    return [(e.time_range.elapsed_us(), e.name) for e in evs]


def compare(name, got, want, dtype_name, tol=TOL):
    atol, rtol = tol[dtype_name]
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    err = float(np.abs(g - w).max()) if g.size else 0.0
    bad = np.abs(g - w) > atol + rtol * np.abs(w)
    log(f"  {name:<44} max_abs_err {err:.3e}  (atol {atol:g}, rtol {rtol:g})"
        f"  {'ok' if not bad.any() else 'FAIL'}")
    if bad.any() or not np.isfinite(g).all():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"tolerance, max_abs_err {err}")
    return err


# -- phase 1-2 ----------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN "
        f"(f32 products run in full f32)")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(logs)} into "
        f"{build.build_dir()}")
    for name, text in logs.items():
        fn = "?"
        for line in text.splitlines():
            m = re.search(r"entry function '\w*?\d+([A-Za-z_]+_kernel)",
                          line)
            if m:   # the kernel whose properties follow
                fn = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"  {name} {fn}: {line.strip()}")


# -- phase 3: kernels ---------------------------------------------------------

def paged_case(torch, *, B, H, Hkv, Dh, bs, nb, max_blk, max_len, window,
               idle, dtype, seed, lens=None, same=False):
    """Random q and pools, a random block table per row, and seq_lens
    drawn from [1, max_len] (or ``lens``); ``window`` > 0 starts each row
    ``window`` positions before its end; ``same``: one pool serves as K
    and V (MLA's latent pool).  Returns (args, valid rows)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32))
    kp = torch.from_numpy(
        rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32))
    vp = torch.from_numpy(
        rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32))
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = (rng.integers(1, max_len + 1, size=B) if lens is None
           else np.asarray(lens))
    if idle:
        seq[1] = 0
    start = np.maximum(seq - window, 0) if window else None
    kp = kp.to(dev, dtype)
    args = [q.to(dev, dtype), kp, kp if same else vp.to(dev, dtype),
            torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(seq.astype(np.int32)).to(dev),
            None if start is None else
            torch.from_numpy(start.astype(np.int32)).to(dev)]
    valid = (seq - (start if start is not None else 0)).clip(min=0)
    return args, int(valid.sum())


def paged_bound_ms(args, n_valid, dtype_name):
    q, kp = args[0], args[1]
    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    el = q.element_size()
    pools = 1 if args[1] is args[2] else 2      # MLA reads one pool
    nbytes = (pools * n_valid * Hkv * Dh * el + 2 * q.numel() * el
              + args[3].numel() * 4 + 2 * B * 4)
    flops = 4 * n_valid * H * Dh
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def moe_case(torch, *, T, E, e_local, off, D, Fd, k, cap, dtype, seed,
             hot=0, dead_p=0.15, direct=False):
    """``direct``: draw the bank in ``dtype`` (a deepseek-v3 bank of 288
    experts is 50.7 GB in f32)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    x = rng.normal(size=(T, D)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = dict(generator=gen, device=dev,
                dtype=dtype if direct else torch.float32)
    g = torch.randn((e_local, D, Fd), **bank).mul_(D ** -0.5)
    u = torch.randn((e_local, D, Fd), **bank).mul_(D ** -0.5)
    d = torch.randn((e_local, Fd, D), **bank).mul_(Fd ** -0.5)
    # routing: distinct experts per token; ``hot`` tokens all pick expert
    # 5 first (overflows cap); ~dead_p of the copies are on dead replicas
    phys = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    for t in range(min(hot, T)):
        phys[t][phys[t] == 5] = phys[t, 0]
        phys[t, 0] = 5
    z = rng.normal(size=(T, k))
    w = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    alive = rng.random(size=(T, k)) >= dead_p
    xt = torch.from_numpy(x).to(dev, dtype)
    args = (xt, g.to(dtype).contiguous(), u.to(dtype).contiguous(),
            d.to(dtype).contiguous(),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(phys.astype(np.int32)).to(dev),
            torch.from_numpy(alive).to(dev))
    return args, dict(cap=cap, expert_offset=off, e_local=e_local)


def moe_bound_ms(args, kw, dtype_name):
    from repro_torch.kernels.moe_fused import moe_group_tokens
    x, gate = args[0], args[1]
    T, D = x.shape
    Fd = gate.shape[2]
    k = args[5].shape[1]
    _, wgt, _ = moe_group_tokens(args[5], args[6], args[4], **kw)
    live_slots = int((wgt != 0).sum())
    live_experts = int((wgt != 0).any(dim=1).sum())
    el = x.element_size()
    nbytes = (live_experts * 3 * D * Fd * el + 2 * T * D * el
              + T * k * (4 + 4 + 1))
    flops = live_slots * 6 * D * Fd
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            live_experts, live_slots)


# moe_fused's cases on the card (name, T, e_local, offset, hot tokens);
# the decode step (T=8) and the chunk step (T = chunk + max_batch = 40)
# are timed
MOE_TIMED = ("decode", "chunk step")


def moe_cases(S):
    return [("decode", S["max_batch"], 64, 0, 0),
            ("chunk, overflow on expert 5", S["chunk"], 64, 0, 12),
            ("chunk, foreign half (offset 32)", S["chunk"], 32, 32, 10),
            ("chunk step", S["chunk"] + S["max_batch"], 64, 0, 0)]


def moe_breakdown(torch, fn, T):
    """moe_fused's device time split between the kernels of moe_fused.cu
    and the sort pass (moe_group_tokens and the launcher's allocations:
    plain PyTorch operations on the device)."""
    rows = kernel_breakdown(torch, fn)
    ours = [(us, k) for us, k in rows
            if "ffn_mma" in k or "combine" in k]
    sort = [(us, k) for us, k in rows if (us, k) not in ours]
    total = sum(us for us, _ in rows)
    log(f"  moe_fused's device time at T={T} (torch.profiler, mean of 20 "
        f"calls, L2 warm): {total:.2f} us; kernels "
        f"{sum(us for us, _ in ours):.2f} us, sort pass "
        f"{sum(us for us, _ in sort):.2f} us "
        f"({100 * sum(us for us, _ in sort) / max(total, 1e-9):.1f}%)")
    for us, key in rows:
        log(f"    {us:9.2f} us  {'kernel' if (us, key) in ours else 'sort':6}"
            f"  {key[:84]}")


def phase_kernels(torch, shapes):
    from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    lap = laps("kernels")
    S = shapes
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    log("kernels: paged_attention vs paged_attention_plain on the card "
        "(splits of 64 positions, merged in split order)")
    errs = []
    timed = {}
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    paged_cases = [
        # name, B, H, Hkv, Dh, window, idle, max_len, and optionally
        # max_blk (default the engine's 32) and fixed lens
        ("decode", S["max_batch"], 16, 16, 128, 0, True, 288),
        ("chunk+window", S["chunk"], 16, 16, 128, 64, True, 288),
        ("gqa Dh=96", 6, 16, 4, 96, 0, True, 200),
        ("gqa Dh=256 window", 5, 8, 2, 256, 40, False, 300),
        # the engine's full context (max_seq 512) at both batch sizes
        ("full context", S["max_batch"], 16, 16, 128, 0, True, 512),
        ("full context", S["chunk"] + S["max_batch"], 16, 16, 128, 0, True,
         512),
        # one long row: 64 splits and their merge
        ("long row", 1, 16, 16, 128, 0, False, 4096, 256, [4090]),
        # a window that starts mid-split (200 = 3 * 64 + 8), and one that
        # leaves the first six splits empty (430 > 6 * 64)
        ("window mid-split", 2, 16, 16, 128, 100, False, 0, mb, [300, 290]),
        ("window, empty splits", 2, 16, 16, 128, 70, False, 0, mb,
         [500, 451]),
    ]
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, H, Hkv, Dh, window, idle, max_len, *more) in \
                enumerate(paged_cases):
            max_blk, lens = more if more else (mb, None)
            args, n_valid = paged_case(
                torch, B=B, H=H, Hkv=Hkv, Dh=Dh, bs=S["block_size"],
                nb=nblk, max_blk=max_blk, max_len=max_len, window=window,
                idle=idle, dtype=dtype, seed=i, lens=lens)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: not bitwise "
                                     f"equal run to run")
            if idle and got[1].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: idle row not 0")
            want = paged_attention_plain(*args)
            errs.append(compare(f"{name} B={B} H={H}/{Hkv} Dh={Dh} "
                                f"({n_valid} rows) {dn}", got, want, dn))
            if dtype is bf16 and name in ("decode", "full context",
                                          "long row"):
                timed[f"{name} B={B}"] = (args, n_valid, dn)
            del args, got, again, want
    for key, (args, n_valid, dn) in timed.items():
        bound, by = paged_bound_ms(args, n_valid, dn)
        r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: paged_attention_cuda(*args)),
            plain_ms=time_ms(torch, lambda: paged_attention_plain(*args)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"{key} H=16 Dh=128 bf16, {n_valid} valid K/V rows")
        log(f"  paged_attention at {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if key == f"decode B={S['max_batch']}":
            out["paged_attention"] = r
            log(f"  paged_attention's kernels at {key} (torch.profiler, mean "
                f"of 20 calls, L2 warm):")
            for us, k in kernel_breakdown(
                    torch, lambda: paged_attention_cuda(*args)):
                log(f"    {us:9.2f} us  {k[:90]}")
    del timed

    log("kernels: moe_fused vs moe_fused_plain on the card")
    errs = []
    timed = {}
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[1]
        for i, (name, T, e_local, off, hot) in enumerate(moe_cases(S)):
            args, kw = moe_case(torch, T=T, E=64, e_local=e_local, off=off,
                                D=S["d_model"], Fd=S["d_ff"], k=S["top_k"],
                                cap=S["cap"], dtype=dtype, seed=10 + i,
                                hot=hot)
            got = moe_fused_cuda(*args, **kw)
            again = moe_fused_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_fused {name}: not bitwise equal "
                                     f"run to run")
            want = moe_fused_plain(*args, **kw)
            _, _, live_e, live_s = moe_bound_ms(args, kw, dn)
            errs.append(compare(
                f"{name} T={T} ({live_e} experts, {live_s} slots) {dn}",
                got, want, dn))
            if name in MOE_TIMED and dtype is bf16:
                timed[T] = (args, kw, dn)
        del args, got, again, want
    rows = {}
    for T, (args, kw, dn) in timed.items():
        bound, by, live_e, live_s = moe_bound_ms(args, kw, dn)
        rows[T] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: moe_fused_cuda(*args, **kw)),
            plain_ms=time_ms(torch, lambda: moe_fused_plain(*args, **kw)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"T={T} D=2048 F=1408 E=64 k=4 cap=8 bf16, {live_e} "
                  f"experts / {live_s} slots live")
        log(f"  moe_fused at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        moe_breakdown(torch, lambda: moe_fused_cuda(*args, **kw), T)
    out["moe_fused"] = rows[S["max_batch"]]
    del timed, args
    gc.collect()
    torch.cuda.empty_cache()
    lap("paged_attention, moe_fused")
    out["router_topk"] = kernels_router(torch)
    lap("router_topk")
    out["decode_megastep"] = kernels_megastep(torch, shapes)
    lap("decode_megastep")
    out["expert_ffn"] = kernels_expert_ffn(torch)
    lap("expert_ffn")
    out["flash_prefill"] = kernels_flash_prefill(torch)
    lap("flash_prefill")
    out["ssm_scan"] = kernels_ssm_scan(torch)
    lap("ssm_scan")
    out.update(kernels_backward(torch))
    lap("backward")
    for layouts, fn in (("mla", lambda: kernels_mla(torch, shapes)),
                        ("dense", lambda: kernels_dense(torch, shapes)),
                        ("hybrid", lambda: kernels_hybrid(torch, shapes)),
                        ("ring", lambda: kernels_ring(torch))):
        for name, rows in fn().items():
            out[name][layouts] = rows
        lap(layouts)
    for name, r in out.items():
        _log_row(name, r)
    return out


def router_case(torch, T, E, masked, seed):
    """Well-separated logits (each row a permutation of 0.25-spaced
    values); row 0 all equal and row 1 with three equal maxima, so the
    lowest index must win."""
    rng = np.random.default_rng(seed)
    logits = (np.stack([rng.permutation(E) for _ in range(T)]) * 0.25
              - 5.0).astype(np.float32)
    logits[0] = 1.0
    logits[1, [9, 4, 30]] = logits[1].max() + 1.0
    mask = np.ones(E, bool)
    mask[list(masked)] = False
    return (torch.from_numpy(logits).cuda(), torch.from_numpy(mask).cuda())


def kernels_router(torch):
    from repro_torch.kernels.router_topk import (router_topk_cuda,
                                                 router_topk_plain)
    log("kernels: router_topk vs router_topk_plain on the card")
    E, k = 60, 4
    errs, timed = [], None
    for T, masked in ((40, ()), (40, (5, 33)), (4096, ()), (4096, (7,))):
        logits, mask = router_case(torch, T, E, masked, seed=T)
        w, idx = router_topk_cuda(logits, mask, k)
        w2, idx2 = router_topk_cuda(logits, mask, k)
        torch.cuda.synchronize()
        if not (torch.equal(w, w2) and torch.equal(idx, idx2)):
            raise AssertionError("router_topk: not bitwise equal run to run")
        want_w, want_idx = router_topk_plain(logits, mask, k)
        if not torch.equal(idx, want_idx):
            raise AssertionError(f"router_topk T={T}: indices differ")
        if idx[0].tolist() != [e for e in range(E) if e not in masked][:k] \
                or idx[1, :3].tolist() != [4, 9, 30]:
            raise AssertionError("router_topk: ties not broken to the "
                                 "lowest index")
        rel = ((w - want_w).abs() / want_w.abs().clamp_min(1e-30)).max()
        errs.append(float((w - want_w).abs().max()))
        log(f"  T={T} E={E} k={k} masked {list(masked)}: indices equal, "
            f"weights max_rel_err {float(rel):.3e} (rtol {ROUTER_RTOL:g})"
            f"  {'ok' if rel <= ROUTER_RTOL else 'FAIL'}")
        if rel > ROUTER_RTOL:
            raise AssertionError("router_topk: weights outside tolerance")
        if T == 40 and not masked:
            timed = (logits, mask)
    logits, mask = timed
    T = logits.shape[0]

    def library():   # the closest PyTorch pair: softmax, then topk
        g = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        return torch.topk(g, k, dim=-1)

    nbytes = T * E * 4 + E + T * k * 8
    flops = T * E * (5 + 2 * k)     # masked softmax, then k argmax passes
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: router_topk_cuda(logits, mask, k)),
        plain_ms=time_ms(torch, lambda: router_topk_plain(logits, mask, k)),
        bound_ms=1e3 * max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=time_ms(torch, library),
        shape=f"chunk T={T} E={E} k={k} f32 (library: softmax + topk)")


QWEN = dict(D=2048, H=16, Hkv=16, Dh=128, E_log=60, R=4, F=1408, Fs=5632,
            k=4)
# deepseek-v3's block at the megastep's latent layout: one pool of R + dr
# = 576 serving as K and V under 128 query heads, 256 + 32 experts, top-8
DEEPSEEK = dict(D=7168, H=128, Hkv=1, Dh=576, E_log=256, R=32, F=2048,
                Fs=2048, k=8)


def megastep_case(torch, S, *, B, dtype, seed, window=0, masked=(),
                  lost=(), dead=(), hot=None, e_local=64, off=0, W=QWEN):
    """Full-width block operands on the card, at the widths ``W`` (qwen2-
    moe-a2.7b, or deepseek-v3's latent layout, whose K and V are one pool
    and whose weights are drawn in ``dtype`` directly).  Row 1 is idle;
    ``dead`` experts lost their first replica (count 1, the redundant slot
    survives); ``hot`` adds ~3 to one expert's logit on every row (over
    capacity at B=40); ``e_local``/``off`` pick the bank slice.  Returns
    (args, kw, valid K/V rows)."""
    D, H, Hkv, Dh, E_log, R = (W[n] for n in ("D", "H", "Hkv", "Dh",
                                               "E_log", "R"))
    mla = W is DEEPSEEK
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        if mla:
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype).mul_(scale)
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def dev(a):
        return torch.from_numpy(a).cuda()

    nb, bs, max_blk = S["num_blocks"] + 1, S["block_size"], S["max_blk"]
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = rng.integers(1, 289, size=B)
    seq[1] = 0
    start = np.maximum(seq - window, 0) if window else np.zeros(B, int)
    u = np.where(rng.random(D) < 0.5, -1.0, 1.0)
    x = rng.normal(size=(B, D)) * (0.3 if hot is not None else 1.0)
    if hot is not None:
        x = x + u
    router = torch.randn((D, E_log), generator=gen, device="cuda") / D ** 0.5
    if hot is not None:
        router[:, hot] += torch.from_numpy(3.0 * u / D).float().cuda()
    ar = np.arange(E_log)
    l2p = np.stack([ar, np.where(ar < R, E_log + ar, 0)], 1)
    rcnt = np.where(ar < R, 2, 1)
    for e in dead:
        l2p[e, 0], rcnt[e] = l2p[e, 1], 1
    rcnt[list(lost)] = 0
    mask = np.ones(E_log, bool)
    mask[list(masked)] = False
    F, Fs = W["F"], W["Fs"]
    pool = randn(nb, bs, Hkv, Dh)
    args = [randn(B, H, Dh), pool, pool if mla else randn(nb, bs, Hkv, Dh),
            dev(tables.astype(np.int32)), dev(seq.astype(np.int32)),
            dev(start.astype(np.int32)), dev(x.astype(np.float32)).to(dtype),
            randn(H * Dh, D, scale=(H * Dh) ** -0.5),
            (1.0 + 0.1 * randn(D).float()).to(dtype), router.to(dtype),
            dev(l2p.astype(np.int32)), dev(rcnt.astype(np.int32)),
            dev(mask), randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, F, D, scale=F ** -0.5), off,
            randn(D, Fs, scale=D ** -0.5), randn(D, Fs, scale=D ** -0.5),
            randn(Fs, D, scale=Fs ** -0.5)]
    from repro_torch.models.moe import capacity
    kw = dict(top_k=W["k"], cap=capacity(B * W["k"], E_log + R, 1.25,
                                         floor=8),
              e_local=e_local)
    return args, kw, int((seq - start).clip(min=0).sum())


# the megastep's cases on the card (name, kwargs of megastep_case); the
# decode step (B=8) and the chunk step (B=40) are timed
MEGA_TIMED = ("decode", "chunk step")


def megastep_cases(S):
    return [
        # name, kwargs of megastep_case
        ("decode", dict(B=S["max_batch"])),
        ("decode, window 64, masked 10/20, lost 5, dead replica of 1",
         dict(B=S["max_batch"], window=64, masked=(10, 20), lost=(5,),
              dead=(1,))),
        ("chunk, expert 40 over capacity, half bank at offset 32",
         dict(B=S["chunk"] + S["max_batch"], hot=40, e_local=32, off=32)),
        ("chunk, window 64, experts 32-59 masked",
         dict(B=S["chunk"] + S["max_batch"], window=64,
              masked=tuple(range(32, 60)))),
        ("chunk step", dict(B=S["chunk"] + S["max_batch"])),
    ]


def megastep_bound_ms(args, kw, route, n_valid, dtype_name):
    """Bytes: w_post, router, shared experts, the experts with a live
    slot, the valid K/V rows, q, x, y, h2; operations: the products."""
    q, x = args[0], args[6]
    B, H, Dh = q.shape
    D = x.shape[1]
    Hkv = args[1].shape[2]
    E_log = args[9].shape[1]
    F, Fs = args[13].shape[2], args[17].shape[1]
    el = x.element_size()
    live_slots = int((route["wgt"] != 0).sum())
    live_experts = int((route["wgt"] != 0).any(dim=1).sum())
    pools = 1 if args[1] is args[2] else 2      # MLA reads one pool
    nbytes = el * (H * Dh * D + D * E_log + 3 * D * Fs
                   + live_experts * 3 * D * F + pools * n_valid * Hkv * Dh
                   + B * H * Dh + 3 * B * D + D)
    flops = (4 * n_valid * H * Dh + 2 * B * H * Dh * D + 2 * B * D * E_log
             + 6 * B * D * Fs + 6 * live_slots * D * F)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            live_experts, live_slots)


def check_megastep(name, args, kw, y, h2, route, dn):
    """A megastep's outputs against its plain version.  Its route tables
    equal the plain router's (router_topk_plain, select_replicas,
    moe_group_tokens) over the logits of its own h2; its h2 and, on every
    row, its y are held at the tolerance against the plain version routed
    from that same h2 (``route_h2``), since routing is a discontinuous
    function of h2.  Returns the max abs errors."""
    from repro_torch.kernels.decode_megastep import decode_megastep_plain
    from repro_torch.kernels.moe_fused import moe_group_tokens
    from repro_torch.kernels.router_topk import router_topk_plain
    from repro_torch.models.moe import MoERuntime, select_replicas
    _, psel = router_topk_plain(h2.float() @ args[9].float(), args[12],
                                kw["top_k"])
    if not route["sel"].equal(psel):
        raise AssertionError(f"decode_megastep {name}: routing differs "
                             f"from router_topk_plain")
    rt = MoERuntime(args[10], args[11], args[12])
    phys, alive = select_replicas(route["sel"].long(), rt)
    tables = moe_group_tokens(phys, alive, route["w"],
                              expert_offset=args[16],
                              e_local=kw["e_local"], cap=kw["cap"])
    for key, want in zip(("tok_idx", "wgt", "slot_of"), tables):
        if not route[key].equal(want):
            raise AssertionError(f"decode_megastep {name}: {key} differs "
                                 f"from moe_group_tokens")
    want_y, want_h2 = decode_megastep_plain(*args, **kw, route_h2=h2)
    dropped = int((route["slot_of"] < 0).sum())
    return [compare(f"{name} h2 {dn}", h2, want_h2, dn, MEGA_TOL),
            compare(f"{name} y {dn} ({dropped} copies dropped)", y, want_y,
                    dn, MEGA_TOL)]


def router_splits(B, D, E_log):
    """How many f32 partials of the router logits the megastep's route
    stage sums: ``split_k`` of ``csrc/decode_megastep.cu`` for the router
    product (K = D over 128-column, 8-row tiles)."""
    def cdiv(a, b):
        return -(-a // b)
    s = cdiv(264, cdiv(E_log, 128) * cdiv(B, 8))
    s = max(min(s, max(1, D // 64)), cdiv(D, 512), 1)
    return cdiv(D, cdiv(D, s))


def route_stage_us(torch, fn, reps: int = 20) -> float:
    """Mean device span of the megastep's route stage over ``reps`` calls
    of ``fn`` (torch.profiler, L2 warm): from route_rows' start to
    route_slots' end, since route_slots is route_rows' programmatic
    dependent and the two overlap."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and "route_" in e.name), key=lambda e: e.time_range.start)
    rows = [e for e in evs if "route_rows" in e.name]
    slots = [e for e in evs if "route_slots" in e.name]
    if not rows or len(rows) != len(slots):
        raise AssertionError(f"route stage: {len(rows)} route_rows and "
                             f"{len(slots)} route_slots launches traced")
    return float(np.mean([s.time_range.end - r.time_range.start
                          for r, s in zip(rows, slots)]))


def kernels_ms(torch, fn) -> float:
    """The device time of the kernels one call of ``fn`` launches, summed,
    in ms (``kernel_breakdown``: torch.profiler, mean of 20 calls, L2
    warm)."""
    return sum(us for us, _ in kernel_breakdown(torch, fn)) / 1e3


def route_stage_row(torch, mega, args, kw, route, h2):
    """The megastep's route stage at its call's inputs: its profiler time
    (``route_stage_us``), its plain version
    (router_topk_plain, select_replicas and moe_group_tokens over the
    logits of the same h2) and the closest library pair (softmax, then
    topk over those logits), beside the bytes of the logit partials it
    reads and the tables it writes.  All three are timed by torch.profiler
    with L2 warm (the stage inside the megastep cannot be timed alone by
    events): the stage as its span, the plain version and the library
    pair as their kernels' summed device time, which leaves out the gaps
    between their launches."""
    from repro_torch.kernels.moe_fused import moe_group_tokens
    from repro_torch.kernels.router_topk import router_topk_plain
    from repro_torch.models.moe import MoERuntime, select_replicas
    B, D = args[6].shape
    E_log, k, cap, e_local = (args[9].shape[1], kw["top_k"], kw["cap"],
                              kw["e_local"])
    logits = h2.float() @ args[9].float()
    mask, rt = args[12], MoERuntime(args[10], args[11], args[12])

    def plain():
        w, sel = router_topk_plain(logits, mask, k)
        phys, alive = select_replicas(sel.long(), rt)
        return moe_group_tokens(phys, alive, w, expert_offset=args[16],
                                e_local=e_local, cap=cap)

    def library():
        g = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        return torch.topk(g, k, dim=-1)

    pw, psel = router_topk_plain(logits, mask, k)
    if not torch.equal(route["sel"], psel):
        raise AssertionError("route stage: routing differs from "
                             "router_topk_plain")
    splits = router_splits(B, D, E_log)
    nbytes = (4 * splits * B * E_log + E_log * (1 + 4 + 4 * args[10].shape[1])
              + 12 * B * k + 8 * e_local * cap)
    flops = B * E_log * (5 + 2 * k)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    us = route_stage_us(torch, mega)
    return dict(
        max_abs_err=float((route["w"] - pw).abs().max()), ms=us / 1e3,
        plain_ms=kernels_ms(torch, plain), bound_ms=1e3 * max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=kernels_ms(torch, library),
        shape=f"route stage B={B} E_log={E_log} k={k} cap={cap} over "
              f"{e_local} experts, {splits} logit partials (torch.profiler,"
              f" mean of 20 calls, L2 warm; ms: the stage's span; plain, "
              f"library (softmax + topk): their kernels' summed time)")


def composed_block(torch):
    """The port's composed chain for the same block (the CUDA attention
    and fused MoE kernels, cuBLAS for the other products): the yardstick
    the megastep replaces.  Its ``moe_fused`` runs on the tensor cores in
    bf16, as the megastep's expert products do."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_fused import moe_fused_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.ffn import ffn_apply
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import MoERuntime, route, select_replicas
    moe_cfg = get_config("qwen2-moe-a2.7b").moe

    def block(args, kw):
        (q, kp, vp, bt, sl, st, x, w_post, ln2, router, l2p, rc, mask, g, u,
         d, off, sg, su, sd) = args
        o = paged_attention_cuda(q, kp, vp, bt, sl, st)
        x2 = x + o.reshape(x.shape[0], -1) @ w_post
        h2 = rms_norm(x2, ln2)
        rt = MoERuntime(l2p, rc, mask)
        w, sel = route(router, h2, rt, moe_cfg)
        phys, alive = select_replicas(sel, rt)
        y = moe_fused_cuda(h2, g, u, d, w, phys, alive, cap=kw["cap"],
                           expert_offset=off, e_local=kw["e_local"])
        return x2 + y + ffn_apply({"w_gate": sg, "w_up": su, "w_down": sd},
                                  h2, "swiglu")
    return block


def kernels_megastep(torch, S):
    from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                     decode_megastep_plain)
    log("kernels: decode_megastep vs decode_megastep_plain on the card "
        "(qwen2-moe-a2.7b block at full width)")
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, case) in enumerate(megastep_cases(S)):
            args, kw, n_valid = megastep_case(torch, S, dtype=dtype,
                                              seed=20 + i, **case)
            y, h2, route = decode_megastep_cuda(*args, **kw,
                                                return_route=True)
            y2, h22 = decode_megastep_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h2, h22)):
                raise AssertionError(f"decode_megastep {name}: not bitwise "
                                     f"equal run to run")
            errs += check_megastep(f"{name} B={args[0].shape[0]}", args,
                                   kw, y, h2, route, dn)
            if name in MEGA_TIMED and dtype is torch.bfloat16:
                timed[args[0].shape[0]] = (args, kw, route, n_valid, dn)
            del args, y, y2, h2, h22, route
            gc.collect()
            torch.cuda.empty_cache()
    block = composed_block(torch)
    rows = {}
    for B, (args, kw, route, n_valid, dn) in timed.items():
        bound, by, live_e, live_s = megastep_bound_ms(args, kw, route,
                                                      n_valid, dn)
        mega = lambda: decode_megastep_cuda(*args, **kw)  # noqa: E731
        # in turns: composed, megastep, megastep, composed
        turns = [time_ms(torch, fn) for fn in (lambda: block(args, kw), mega,
                                               mega, lambda: block(args, kw))]
        rows[B] = r = dict(
            max_abs_err=max(errs), ms=(turns[1] + turns[2]) / 2,
            plain_ms=time_ms(torch,
                             lambda: decode_megastep_plain(*args, **kw)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"B={B} D=2048 H=16 Dh=128 E=64 F=1408 Fs=5632 k=4 "
                  f"cap={kw['cap']} bf16, {n_valid} valid K/V rows, "
                  f"{live_e} experts / {live_s} slots live")
        log(f"  decode_megastep at {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        log(f"  decode_megastep at B={B} in turns with the composed chain of "
            f"the same block (CUDA attention + moe_fused, now on the tensor "
            f"cores in bf16, + cuBLAS products): composed {turns[0]:.4f}, "
            f"megastep {turns[1]:.4f}, megastep {turns[2]:.4f}, composed "
            f"{turns[3]:.4f} ms")
        log(f"  decode_megastep's kernels at B={B} (torch.profiler, mean of "
            f"20 calls, L2 warm):")
        for us, key in kernel_breakdown(torch, mega):
            log(f"    {us:9.2f} us  {key[:90]}")
        log(f"  decode_megastep's route stage at B={B} E_log=60 k=4: "
            f"{route_stage_us(torch, mega):.2f} us (torch.profiler, route_rows"
            f"' start to route_slots' end, mean of 20 calls, L2 warm)")
        log(f"  decode_megastep's launches at B={B}, one call in order "
            f"(torch.profiler):")
        for us, key in kernel_sequence(torch, mega):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed, args
    gc.collect()
    torch.cuda.empty_cache()
    return rows[S["max_batch"]]


def expert_ffn_args(torch, C, dtype, E=64, W=QWEN):
    """A layer's E experts over a C-row capacity buffer: qwen2-moe-a2.7b's
    64, or deepseek-v3's (drawn in ``dtype`` directly)."""
    D, Fd = W["D"], W["F"]
    gen = torch.Generator(device="cuda").manual_seed(30 + C)

    def randn(*shape, scale=1.0):
        if W is DEEPSEEK:
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype).mul_(scale)
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    return (randn(E, C, D), randn(E, D, Fd, scale=D ** -0.5),
            randn(E, D, Fd, scale=D ** -0.5),
            randn(E, Fd, D, scale=Fd ** -0.5))


def kernels_expert_ffn(torch):
    """The dense-scatter MoE's expert FFN at the serial path's shapes: all
    64 experts of a qwen2-moe-a2.7b layer over a capacity buffer of C=8
    rows (decode), C=20 (a 256-token prefill bucket) and C=40 (512)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,
                                                expert_ffn_plain)
    log("kernels: expert_ffn vs expert_ffn_plain on the card (64 experts, "
        "D=2048, F=1408)")
    E, D, Fd = 64, QWEN["D"], QWEN["F"]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for C in (8, 20, 40):
            args = expert_ffn_args(torch, C, dtype)
            got = expert_ffn_cuda(*args)
            again = expert_ffn_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"expert_ffn C={C}: not bitwise equal "
                                     f"run to run")
            errs.append(compare(f"E={E} C={C} D={D} F={Fd} {dn}", got,
                                expert_ffn_plain(*args), dn, FFN_TOL))
            if dtype is torch.bfloat16:
                timed[C] = args
            del got, again, args

    def library(x, g, u, d):    # the closest torch.bmm chain
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)

    rows = {}
    for C, args in timed.items():
        el = args[0].element_size()
        nbytes = el * (3 * E * D * Fd + 2 * E * C * D)
        flops = 6 * E * C * D * Fd
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
        rows[C] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: expert_ffn_cuda(*args)),
            plain_ms=time_ms(torch, lambda: expert_ffn_plain(*args)),
            bound_ms=1e3 * max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=time_ms(torch, lambda: library(*args)),
            shape=f"E={E} C={C} D={D} F={Fd} bf16 (library: silu(bmm) * "
                  f"bmm, then bmm)")
        log(f"  expert_ffn at C={C}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / r['ms'] / 1e6:.0f} GB/s of the "
            f"bound's bytes), "
            f"library {r['library_ms']:.4f} ms")
        log(f"  expert_ffn's kernels at C={C} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, key in kernel_breakdown(torch, lambda: expert_ffn_cuda(*args)):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed
    gc.collect()
    torch.cuda.empty_cache()
    return rows[8]


def flash_bound_ms(S, H, Hkv, Dh, window, el, dtype_name, Dv=None, *,
                   B=1, Skv=None, causal=True):
    """Bytes: q, k, v and out once; operations: QK^T and PV over the
    (query, key) pairs this mask leaves visible.  ``Dv``: V's width where
    it is not the QK width Dh.  S queries over ``Skv`` keys (default S),
    ``B`` rows; not ``causal``: every pair is visible."""
    Dv = Dv or Dh
    Skv = Skv or S
    i = np.arange(S)
    visible = (S * Skv if not causal else
               int(np.minimum(i + 1, window).sum() if window
                   else (i + 1).sum()))
    nbytes = el * B * (S * H * (Dh + Dv) + Skv * Hkv * (Dh + Dv))
    flops = 2 * B * visible * H * (Dh + Dv)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def kernels_flash_prefill(torch):
    """Whole-prompt attention at the serial path's buckets (B=1, H=Hkv=16,
    Dh=128), causal, with and without the sliding window 6."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    log("kernels: flash_prefill vs flash_prefill_plain on the card (B=1, "
        "H=Hkv=16, Dh=128)")
    H = Hkv = QWEN["H"]
    Dh = QWEN["Dh"]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for S in (16, 200, 256, 512):
            for window in (0, 6):
                gen = torch.Generator(device="cuda").manual_seed(S + window)
                q, k, v = (torch.randn((1, S, h, Dh), generator=gen,
                                       device="cuda").to(dtype)
                           for h in (H, Hkv, Hkv))
                pos = torch.arange(S, dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window)
                got = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                again = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_prefill S={S}: not bitwise "
                                         f"equal run to run")
                want = flash_prefill_plain(q, k, v, pos, pos, **kw)
                errs.append(compare(f"S={S} window {window} {dn}", got,
                                    want, dn, FLASH_TOL))
                if S >= 256 and not window and dtype is torch.bfloat16:
                    timed[S] = (q, k, v, pos)
    rows = {}
    for S, (q, k, v, pos) in timed.items():
        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        def kernel():
            return flash_prefill_cuda(q, k, v, pos, pos)

        bound, by = flash_bound_ms(S, H, Hkv, Dh, 0, q.element_size(),
                                   "bfloat16")
        rows[S] = r = dict(
            max_abs_err=max(errs), ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos,
                                                                pos)),
            bound_ms=bound, bound_by=by, library_ms=time_ms(torch, library),
            shape=f"B=1 S={S} H=Hkv={H} Dh={Dh} causal bf16 (library: "
                  f"scaled_dot_product_attention)")
        log(f"  flash_prefill at S={S}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']:.4f} ms")
        log(f"  flash_prefill's kernels at S={S} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, key in kernel_breakdown(torch, kernel):
            log(f"    {us:9.2f} us  {key[:90]}")
    return rows[256]


FALCON = dict(d_inner=8192, N=16)


def ssm_case(torch, B, S, *, with_h0, dtype, seed, d=FALCON["d_inner"]):
    """falcon-mamba-7b's scan operands at full width (or ``d`` channels),
    drawn as tests/test_kernels.py draws them: dt = softplus(z - 2), A =
    -exp(0.3 z); h0 (the slot state) in the working type."""
    N = FALCON["N"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    args = [(randn(B, S, d) * 0.1).to(dtype),
            torch.nn.functional.softplus(randn(B, S, d) - 2).to(dtype),
            -torch.exp(randn(d, N) * 0.3),
            (randn(B, S, N) * 0.2).to(dtype), (randn(B, S, N) * 0.2).to(dtype),
            (randn(B, d, N) * 0.5).to(dtype) if with_h0 else None]
    return args


def ssm_bound_ms(args, h_dtype=None, y_dtype=None):
    """Bytes: u, dt, A, B, C and h0 once, y and h_final once (f32, or the
    in-place mode's types); operations: ~7 f32 operations per (row, step,
    channel, state)."""
    u, _, A, Bm, _, h0 = args
    B, S, d = u.shape
    N = A.shape[1]
    el = u.element_size()
    h_el = 4 if h_dtype is None else h_dtype.itemsize
    y_el = 4 if y_dtype is None else y_dtype.itemsize
    nbytes = (2 * B * S * d * el + d * N * 4 + 2 * B * S * N * el
              + (0 if h0 is None else h0.numel() * h0.element_size())
              + B * S * d * y_el + B * d * N * h_el)
    flops = 7 * B * S * d * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def kernels_ssm_scan(torch):
    """The selective scan at the ssm path's shapes: a whole-prompt prefill
    of one row (d_inner 8192, N 16) at buckets 200, 256, 512 and 2048 from
    a zero state, and the decode step of 8 slots from their state, in the
    default mode (f32 y and h_final) and in the engine's in-place mode (the
    bf16 state written where it lies, y in bf16)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    log("kernels: ssm_scan vs ssm_scan_plain on the card (falcon-mamba-7b: "
        "d_inner 8192, N 16)")
    cases = [("prefill", 1, S, False) for S in (200, 256, 512, 2048)]
    cases.append(("decode", 8, 1, True))
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, S, with_h0) in enumerate(cases):
            args = ssm_case(torch, B, S, with_h0=with_h0, dtype=dtype,
                            seed=40 + i)
            y, h = ssm_scan_cuda(*args)
            y2, h2 = ssm_scan_cuda(*args)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h, h2)):
                raise AssertionError(f"ssm_scan {name} S={S}: not bitwise "
                                     f"equal run to run")
            want_y, want_h = ssm_scan_plain(*args)
            for part, got, want in (("y", y, want_y), ("h_final", h, want_h)):
                errs.append(compare(f"{name} B={B} S={S} {part} {dn}", got,
                                    want, dn, SSM_TOL))
            if with_h0:
                errs += ssm_in_place(torch, args, dn)
            if dtype is torch.bfloat16:
                timed[(name, S)] = args
            del y, y2, h, h2, want_y, want_h
    rows = {}
    for (name, S), args in timed.items():
        bound, by = ssm_bound_ms(args)
        rows[(name, S)] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: ssm_scan_cuda(*args)),
            # the plain loop at S = 2048 takes ~0.5 s a call
            plain_ms=(time_ms(torch, lambda: ssm_scan_plain(*args))
                      if S <= 512 else float("nan")),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"{name} B={args[0].shape[0]} S={S} d=8192 N=16 bf16 "
                  f"(library: none, no PyTorch call computes a selective "
                  f"scan)")
        log(f"  ssm_scan at {name} B={args[0].shape[0]} S={S}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # the decode step as the engine runs it: in place, y in bf16
    args = timed[("decode", 1)]
    state = args[5].clone()
    bf16 = torch.bfloat16
    bound, by = ssm_bound_ms(args, bf16, bf16)
    ms = time_ms(torch, lambda: ssm_scan_cuda(*args[:5], state, h_out=state,
                                              y_dtype=bf16))
    plain = time_ms(torch, lambda: ssm_scan_plain(
        *args[:5], state, h_out=state, y_dtype=bf16))
    log(f"  ssm_scan at decode B=8 S=1 in place (bf16 state, y in bf16): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by}), library: none")
    prefill = timed[("prefill", 256)]
    for what, fn in (
            ("prefill B=1 S=256", lambda: ssm_scan_cuda(*prefill)),
            ("decode B=8 in place", lambda: ssm_scan_cuda(
                *args[:5], state, h_out=state, y_dtype=bf16))):
        log(f"  ssm_scan's kernels at {what} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, k in kernel_breakdown(torch, fn):
            log(f"    {us:9.2f} us  {k[:90]}")
    del timed, args, state, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return rows[("prefill", 256)]


def ssm_in_place(torch, args, dn):
    """The decode step's in-place mode against the plain version's: the
    state written in its own type where it lies (its storage pointer
    unchanged), y in the inputs' type; bitwise equal run to run."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    u, dt, A, Bm, Cm, h0 = args
    ys, states = [], []
    for _ in range(2):
        state = h0.clone()
        ptr = state.data_ptr()
        y, h = ssm_scan_cuda(u, dt, A, Bm, Cm, state, h_out=state,
                             y_dtype=u.dtype)
        if h.data_ptr() != ptr or state.data_ptr() != ptr:
            raise AssertionError("ssm_scan in place: the state moved")
        ys.append(y)
        states.append(state)
    torch.cuda.synchronize()
    if not (torch.equal(ys[0], ys[1]) and torch.equal(*states)):
        raise AssertionError("ssm_scan in place: not bitwise equal run to "
                             "run")
    want_state = h0.clone()
    want_y, _ = ssm_scan_plain(u, dt, A, Bm, Cm, want_state,
                               h_out=want_state, y_dtype=u.dtype)
    B = u.shape[0]
    # the state is the h_final of the default mode, cast: bitwise the plain
    # version's; y is the plain version's within the scan's tolerance, and
    # then one rounding to the state's type
    if not torch.equal(states[0], want_state):
        raise AssertionError("ssm_scan in place: state differs from the "
                             "plain version's")
    log(f"  decode B={B} in place: state bitwise the plain version's "
        f"({states[0].dtype}), storage unchanged")
    tol = SSM_TOL if u.dtype == torch.float32 else TOL
    return [compare(f"decode B={B} in place y {dn}", ys[0], want_y, dn,
                    tol)]


# -- phase 3, deepseek-v3's shapes ----------------------------------------------

def _row(errs, ms, plain_ms, bound, shape, library_ms=None):
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
                shape=shape)


def _log_row(name, r):
    log(f"  {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})" + ("" if r["library_ms"] is None else
                                f", library {r['library_ms']:.4f} ms"))


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def kernels_mla(torch, S):
    """The kernels of the mla_* paths at deepseek-v3's shapes, each against
    its plain version in f32 and bf16, twice and bitwise equal; the bf16
    cases at the main path's shapes timed beside their bounds.  Returns
    {kernel: [rows]}."""
    mega_rows, route_rows = mla_megastep(torch, S)
    out = {"paged_attention": mla_paged(torch, S),
           "decode_megastep": mega_rows,
           "router_topk": route_rows,
           "flash_prefill": mla_flash(torch),
           "moe_fused": mla_moe_fused(torch, S),
           "expert_ffn": mla_expert_ffn(torch)}
    for name, rows in out.items():
        for r in rows:
            _log_row(name, r)
    return out


def mla_paged(torch, S):
    """Paged attention at the latent layout: Hkv = 1, G = 128, Da = 576,
    one pool as K and V, at the engine's context (512 positions) for a
    decode step (B=8) and a chunk step (B=40), over one 4090-position row
    (16 splits of 256), and windowed with an idle row.  In bf16 these run
    the tensor-core latent kernel."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    W = DEEPSEEK
    log("kernels: paged_attention at deepseek-v3's latent layout (Hkv=1, "
        "G=128, Da=576, K = V one pool) vs its plain version")
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    cases = [
        # name, B, window, idle, max_len, max_blk, lens
        ("decode", S["max_batch"], 0, True, 512, mb, None),
        ("chunk step", S["chunk"] + S["max_batch"], 0, True, 512, mb, None),
        ("long row", 1, 0, False, 0, 256, [4090]),
        ("window 70", 3, 70, True, 0, mb, [500, 0, 131]),
    ]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, window, idle, max_len, max_blk, lens) in \
                enumerate(cases):
            args, n_valid = paged_case(
                torch, B=B, H=W["H"], Hkv=1, Dh=W["Dh"], bs=S["block_size"],
                nb=max(nblk, max_blk + 2), max_blk=max_blk, max_len=max_len,
                window=window, idle=idle, dtype=dtype, seed=60 + i,
                lens=lens, same=True)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention latent {name}: not "
                                     f"bitwise equal run to run")
            if idle and got[1].abs().max().item() != 0.0:
                raise AssertionError("paged_attention latent: idle row not 0")
            errs.append(compare(f"latent {name} B={B} ({n_valid} rows) {dn}",
                                got, paged_attention_plain(*args), dn))
            if dtype is torch.bfloat16 and name != "window 70":
                timed[name] = (args, n_valid, dn)
            del args, got, again
    rows = []
    for name, (args, n_valid, dn) in timed.items():
        B = args[0].shape[0]
        rows.append(_row(
            errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
            time_ms(torch, lambda: paged_attention_plain(*args)),
            paged_bound_ms(args, n_valid, dn),
            f"{name} B={B} H=128 Hkv=1 Da=576 bf16, {n_valid} valid latent "
            f"rows (K = V)"))
        if name in ("decode", "chunk step"):
            log(f"  paged_attention's kernels at latent {name} B={B} "
                f"(torch.profiler, mean of 20 calls, L2 warm):")
            for us, k in kernel_breakdown(
                    torch, lambda: paged_attention_cuda(*args)):
                log(f"    {us:9.2f} us  {k[:90]}")
    del timed
    _free(torch)
    return rows


INTERNLM = dict(H=48, Hkv=8, Dh=128)        # internlm2-20b: G = 6
MINICPM = dict(H=40, Da=256 + 32)           # minicpm3-4b's latent layout


def kernels_dense(torch, S):
    """The dense family's new layouts, each against its plain version in
    f32 and bf16, twice and bitwise equal: paged attention at
    internlm2-20b's GQA (H 48 over Hkv 8, G = 6 query heads a KV head,
    Dh 128: two head groups a CTA pair) and at minicpm3-4b's MLA latent
    layout (Hkv 1, G 40, Da = 256 + 32 = 288, one pool as K and V: the
    wide kernel, since the latent kernel takes Da 576 and G a multiple of
    64), at decode (B=8) and chunk (B=40) rows over the engine's context,
    internlm2's also windowed; whole-prompt attention at internlm2-20b's
    widths, S = 200 and 256, with and without window 6.  The bf16 decode
    rows and S = 256 are timed beside their bounds (flash_prefill also
    beside ``scaled_dot_product_attention``).  Returns {kernel: [rows]}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain,
                                                     takes_latent_kernel)
    log("kernels: paged_attention at internlm2-20b's GQA (H=48, Hkv=8, "
        "Dh=128) and minicpm3-4b's latent layout (H=40, Hkv=1, Da=288, K "
        "= V one pool) vs its plain version")
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    dec, chunk = S["max_batch"], S["chunk"] + S["max_batch"]
    gi, lat = INTERNLM, MINICPM
    cases = [
        # name, B, H, Hkv, Dh, window, idle, max_len, same pool
        ("internlm2 decode", dec, gi["H"], gi["Hkv"], gi["Dh"], 0, True,
         288, False),
        ("internlm2 chunk step", chunk, gi["H"], gi["Hkv"], gi["Dh"], 0,
         True, 512, False),
        ("internlm2 window 70", 5, gi["H"], gi["Hkv"], gi["Dh"], 70, True,
         512, False),
        ("minicpm3 latent decode", dec, lat["H"], 1, lat["Da"], 0, True,
         512, True),
        ("minicpm3 latent chunk step", chunk, lat["H"], 1, lat["Da"], 0,
         True, 512, True),
    ]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, H, Hkv, Dh, window, idle, max_len, same) in \
                enumerate(cases):
            args, n_valid = paged_case(
                torch, B=B, H=H, Hkv=Hkv, Dh=Dh, bs=S["block_size"],
                nb=nblk, max_blk=mb, max_len=max_len, window=window,
                idle=idle, dtype=dtype, seed=80 + i, same=same)
            if takes_latent_kernel(*args[:3]):
                raise AssertionError(f"paged_attention {name}: took the "
                                     f"latent kernel's layout")
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: not bitwise "
                                     f"equal run to run")
            if idle and got[1].abs().max().item() != 0.0:
                raise AssertionError(f"paged_attention {name}: idle row "
                                     f"not 0")
            errs.append(compare(f"{name} B={B} H={H}/{Hkv} Dh={Dh} "
                                f"({n_valid} rows) {dn}", got,
                                paged_attention_plain(*args), dn))
            if dtype is torch.bfloat16 and "window" not in name:
                timed[name] = (args, n_valid, dn)
            del args, got, again
    rows = {"paged_attention": [], "flash_prefill": []}
    for name, (args, n_valid, dn) in timed.items():
        B, H, Dh = args[0].shape
        rows["paged_attention"].append(_row(
            errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
            time_ms(torch, lambda: paged_attention_plain(*args)),
            paged_bound_ms(args, n_valid, dn),
            f"{name} B={B} H={H} Hkv={args[1].shape[2]} Dh={Dh} bf16, "
            f"{n_valid} valid K/V rows"
            + (" (K = V)" if args[1] is args[2] else "")))
    del timed
    _free(torch)

    log("kernels: flash_prefill at internlm2-20b's widths (B=1, H=48, "
        "Hkv=8, Dh=128) vs its plain version")
    H, Hkv, Dh = gi["H"], gi["Hkv"], gi["Dh"]
    errs, timed = [], None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for Sq in (200, 256):
            for window in (0, 6):
                gen = torch.Generator(device="cuda").manual_seed(Sq + window)
                q, k, v = (torch.randn((1, Sq, h, Dh), generator=gen,
                                       device="cuda").to(dtype)
                           for h in (H, Hkv, Hkv))
                pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window)
                got = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                again = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_prefill internlm2 S={Sq}: "
                                         f"not bitwise equal run to run")
                errs.append(compare(
                    f"internlm2 S={Sq} window {window} {dn}", got,
                    flash_prefill_plain(q, k, v, pos, pos, **kw), dn,
                    FLASH_TOL))
                if Sq == 256 and not window and dtype is torch.bfloat16:
                    timed = (q, k, v, pos)
    q, k, v, pos = timed

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    def kernel():
        return flash_prefill_cuda(q, k, v, pos, pos)

    rows["flash_prefill"].append(_row(
        errs, time_ms(torch, kernel),
        time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos, pos)),
        flash_bound_ms(256, H, Hkv, Dh, 0, q.element_size(), "bfloat16"),
        f"B=1 S=256 H={H} Hkv={Hkv} Dh={Dh} causal bf16 (library: "
        f"scaled_dot_product_attention)", time_ms(torch, library)))
    del timed, q, k, v
    _free(torch)
    for name, rs in rows.items():
        for r in rs:
            _log_row(name, r)
    return rows


# jamba-1.5-large-398b's widths, its bank as the hybrid path cuts it
JAMBA = dict(H=64, Hkv=8, Dh=128, D=8192, F=24576, E=HYBRID_EXPERTS, k=2,
             d_inner=16384)


def kernels_hybrid(torch, S):
    """The hybrid path's four kernels at jamba-1.5-large-398b's layouts,
    each against its plain version in f32 and bf16, twice and bitwise
    equal: paged attention at H 64 over Hkv 8 (G = 8: two head groups a
    split), Dh 128, at decode B = 8 over 288 and over the engine's 512
    positions; whole-prompt attention at those heads, S = 200 and 256;
    the selective scan at d_inner 16384, N 16: a prefill row at S = 200
    and 256 from zero, and the decode step of 8 slots from their state
    (also in the engine's in-place mode); the fused MoE at D 8192, F
    24576, the path's bank of 4 experts, top-2: decode T = 8 (cap 8) and
    one prompt's prefill T = 256 (cap 160).  The bf16 decode and S = 256
    or T = 256 rows are timed beside their bounds (flash_prefill beside
    ``scaled_dot_product_attention``).  Returns {kernel: [rows]}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    J = JAMBA
    rows = {"paged_attention": [], "flash_prefill": [], "ssm_scan": [],
            "moe_fused": []}
    log("kernels: paged_attention at jamba-1.5-large-398b's GQA (H=64, "
        "Hkv=8: G = 8, Dh=128) vs its plain version")
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, max_len) in enumerate((("decode", 288),
                                             ("full context", 512))):
            args, n_valid = paged_case(
                torch, B=S["max_batch"], H=J["H"], Hkv=J["Hkv"], Dh=J["Dh"],
                bs=S["block_size"], nb=nblk, max_blk=mb, max_len=max_len,
                window=0, idle=True, dtype=dtype, seed=90 + i)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention jamba {name}: not "
                                     f"bitwise equal run to run")
            if got[1].abs().max().item() != 0.0:
                raise AssertionError("paged_attention jamba: idle row not 0")
            errs.append(compare(f"jamba {name} B={S['max_batch']} H=64/8 "
                                f"Dh=128 ({n_valid} rows) {dn}", got,
                                paged_attention_plain(*args), dn))
            if dtype is torch.bfloat16:
                timed[name] = (args, n_valid, dn)
            del args, got, again
    for name, (args, n_valid, dn) in timed.items():
        rows["paged_attention"].append(_row(
            errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
            time_ms(torch, lambda: paged_attention_plain(*args)),
            paged_bound_ms(args, n_valid, dn),
            f"jamba {name} B={S['max_batch']} H=64 Hkv=8 Dh=128 bf16, "
            f"{n_valid} valid K/V rows"))
    del timed
    _free(torch)

    log("kernels: flash_prefill at jamba-1.5-large-398b's heads (B=1, "
        "H=64, Hkv=8, Dh=128) vs its plain version")
    H, Hkv, Dh = J["H"], J["Hkv"], J["Dh"]
    errs, timed = [], None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for Sq in (200, 256):
            gen = torch.Generator(device="cuda").manual_seed(Sq + 7)
            q, k, v = (torch.randn((1, Sq, h, Dh), generator=gen,
                                   device="cuda").to(dtype)
                       for h in (H, Hkv, Hkv))
            pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
            got = flash_prefill_cuda(q, k, v, pos, pos)
            again = flash_prefill_cuda(q, k, v, pos, pos)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_prefill jamba S={Sq}: not "
                                     f"bitwise equal run to run")
            errs.append(compare(f"jamba S={Sq} {dn}", got,
                                flash_prefill_plain(q, k, v, pos, pos), dn,
                                FLASH_TOL))
            if Sq == 256 and dtype is torch.bfloat16:
                timed = (q, k, v, pos)
    q, k, v, pos = timed

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    rows["flash_prefill"].append(_row(
        errs, time_ms(torch, lambda: flash_prefill_cuda(q, k, v, pos, pos)),
        time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos, pos)),
        flash_bound_ms(256, H, Hkv, Dh, 0, q.element_size(), "bfloat16"),
        f"jamba B=1 S=256 H={H} Hkv={Hkv} Dh={Dh} causal bf16 (library: "
        f"scaled_dot_product_attention)", time_ms(torch, library)))
    del timed, q, k, v
    _free(torch)

    log("kernels: ssm_scan at jamba-1.5-large-398b's width (d_inner 16384, "
        "N 16) vs its plain version")
    errs, timed = [], {}
    cases = [("prefill", 1, 200, False), ("prefill", 1, 256, False),
             ("decode", 8, 1, True)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, Sq, with_h0) in enumerate(cases):
            args = ssm_case(torch, B, Sq, with_h0=with_h0, dtype=dtype,
                            seed=95 + i, d=J["d_inner"])
            y, h = ssm_scan_cuda(*args)
            y2, h2 = ssm_scan_cuda(*args)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h, h2)):
                raise AssertionError(f"ssm_scan jamba {name} S={Sq}: not "
                                     f"bitwise equal run to run")
            want_y, want_h = ssm_scan_plain(*args)
            for part, got, want in (("y", y, want_y), ("h_final", h, want_h)):
                errs.append(compare(f"jamba {name} B={B} S={Sq} {part} {dn}",
                                    got, want, dn, SSM_TOL))
            if with_h0:
                errs += ssm_in_place(torch, args, dn)
            if dtype is torch.bfloat16 and Sq in (1, 256):
                timed[name] = args
            del y, y2, h, h2, want_y, want_h
    args = timed["prefill"]
    rows["ssm_scan"].append(_row(
        errs, time_ms(torch, lambda: ssm_scan_cuda(*args)),
        time_ms(torch, lambda: ssm_scan_plain(*args)), ssm_bound_ms(args),
        "jamba prefill B=1 S=256 d=16384 N=16 bf16 (library: none)"))
    args = timed["decode"]
    state, bf16 = args[5].clone(), torch.bfloat16
    rows["ssm_scan"].append(_row(
        errs, time_ms(torch, lambda: ssm_scan_cuda(
            *args[:5], state, h_out=state, y_dtype=bf16)),
        time_ms(torch, lambda: ssm_scan_plain(
            *args[:5], state, h_out=state, y_dtype=bf16)),
        ssm_bound_ms(args, bf16, bf16),
        "jamba decode B=8 S=1 d=16384 N=16 in place (bf16 state, y in "
        "bf16; library: none)"))
    del timed, args, state
    _free(torch)

    log("kernels: moe_fused at jamba-1.5-large-398b's widths (D=8192, "
        "F=24576, 4 experts, top-2) vs its plain version")
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, T, cap) in enumerate((("decode", S["max_batch"], 8),
                                            ("prefill", 256, 160))):
            args, kw = moe_case(torch, T=T, E=J["E"], e_local=J["E"], off=0,
                                D=J["D"], Fd=J["F"], k=J["k"], cap=cap,
                                dtype=dtype, seed=97 + i)
            got = moe_fused_cuda(*args, **kw)
            again = moe_fused_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_fused jamba {name}: not bitwise "
                                     f"equal run to run")
            _, _, live_e, live_s = moe_bound_ms(args, kw, dn)
            errs.append(compare(
                f"jamba {name} T={T} cap={cap} ({live_e} experts, {live_s} "
                f"slots) {dn}", got, moe_fused_plain(*args, **kw), dn))
            if dtype is torch.bfloat16:
                timed[name] = (args, kw, dn)
            del got, again
            if dtype is torch.float32:
                del args
                _free(torch)
    for name, (args, kw, dn) in timed.items():
        bound, by, live_e, live_s = moe_bound_ms(args, kw, dn)
        rows["moe_fused"].append(_row(
            errs, time_ms(torch, lambda: moe_fused_cuda(*args, **kw)),
            time_ms(torch, lambda: moe_fused_plain(*args, **kw)),
            (bound, by),
            f"jamba {name} T={args[0].shape[0]} D=8192 F=24576 E=4 k=2 "
            f"cap={kw['cap']} bf16, {live_e} experts / {live_s} slots "
            f"live"))
    del timed
    _free(torch)
    for name, rs in rows.items():
        for r in rs:
            _log_row(name, r)
    return rows


# the ring serve step's layouts: internvl2-26b (G = 6, Dh 128; 256
# patches) and seamless-m4t-large-v2 (G = 1, Dh 64; 1536 frames), at the
# engine phase's vlm and audio paths' batch of 4 and rings
INTERNVL = dict(H=48, Hkv=8, Dh=128, patches=256, ring=384)
SEAMLESS = dict(H=16, Hkv=16, Dh=64, frames=1536, ring=128)


def kernels_ring(torch):
    """The two attention kernels at the ring serve step's new layouts and
    modes, each against its plain version in f32 and bf16, twice and
    bitwise equal; each bf16 case timed beside its bound and, for
    ``flash_prefill``, ``scaled_dot_product_attention``: whole-prompt
    attention not causal over keys of another length (seamless's encoder,
    S 1536; its decoder's cross-attention prefill, 16 queries over the
    1536 frames) and internvl2's causal prefill of 256 patches + 64
    tokens; ``paged_attention`` over a ring viewed as a pool
    (``attention.ring_page``: one block of W rows a row, the identity
    table, seq_lens = min(pos + 1, W)) at internvl2's W 384, seamless's W
    128, and the cross decode over all 1536 frames.  Returns {kernel:
    [rows]}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.models.attention import ring_page
    iv, sm = INTERNVL, SEAMLESS
    log("kernels: flash_prefill and paged_attention at the ring serve "
        "step's layouts (internvl2-26b, seamless-m4t-large-v2) vs their "
        "plain versions")
    rows = {"flash_prefill": [], "paged_attention": []}
    flash_cases = [
        # name, B, Sq, Skv, H, Hkv, Dh, causal
        ("seamless encoder", 4, sm["frames"], sm["frames"], sm["H"],
         sm["Hkv"], sm["Dh"], False),
        ("seamless cross prefill", 4, 16, sm["frames"], sm["H"], sm["Hkv"],
         sm["Dh"], False),
        ("internvl2 prefill", 4, iv["patches"] + 64, iv["patches"] + 64,
         iv["H"], iv["Hkv"], iv["Dh"], True),
    ]
    for name, B, Sq, Skv, H, Hkv, Dh, causal in flash_cases:
        errs, timed = [], None
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            gen = torch.Generator(device="cuda").manual_seed(Sq + Skv)
            q, k, v = (torch.randn((B, n, h, Dh), generator=gen,
                                   device="cuda").to(dtype)
                       for n, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
            qp = torch.arange(Sq, dtype=torch.int32, device="cuda")
            kp = torch.arange(Skv, dtype=torch.int32, device="cuda")
            got = flash_prefill_cuda(q, k, v, qp, kp, causal=causal)
            again = flash_prefill_cuda(q, k, v, qp, kp, causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_prefill {name}: not bitwise "
                                     f"equal run to run")
            errs.append(compare(
                f"{name} B={B} Sq={Sq} Skv={Skv} H={H}/{Hkv} Dh={Dh} {dn}",
                got, flash_prefill_plain(q, k, v, qp, kp, causal=causal),
                dn, FLASH_TOL))
            timed = (q, k, v, qp, kp)
            del got, again
        q, k, v, qp, kp = timed

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        rows["flash_prefill"].append(_row(
            errs,
            time_ms(torch, lambda: flash_prefill_cuda(q, k, v, qp, kp,
                                                      causal=causal)),
            time_ms(torch, lambda: flash_prefill_plain(q, k, v, qp, kp,
                                                       causal=causal)),
            flash_bound_ms(Sq, H, Hkv, Dh, 0, q.element_size(), "bfloat16",
                           B=B, Skv=Skv, causal=causal),
            f"{name} B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} Dh={Dh} "
            f"{'causal' if causal else 'not causal'} bf16 (library: "
            f"scaled_dot_product_attention)", time_ms(torch, library)))
        del timed, q, k, v
        _free(torch)

    ring_cases = [
        # name, H, Hkv, Dh, W, each row's position (B = 4)
        ("internvl2 ring decode", iv["H"], iv["Hkv"], iv["Dh"], iv["ring"],
         [272, 300, 330, 383]),
        ("seamless ring decode", sm["H"], sm["Hkv"], sm["Dh"], sm["ring"],
         [10, 17, 30, 47]),
        ("seamless cross decode", sm["H"], sm["Hkv"], sm["Dh"],
         sm["frames"], [sm["frames"] - 1] * 4),
    ]
    for i, (name, H, Hkv, Dh, W, pos) in enumerate(ring_cases):
        errs, timed = [], None
        B = len(pos)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            gen = torch.Generator(device="cuda").manual_seed(90 + i)
            q = torch.randn((B, H, Dh), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((B, W, Hkv, Dh), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            tables, seq_lens = ring_page(
                torch.tensor(pos, dtype=torch.int32, device="cuda"), W)
            args = (q, k, v, tables, seq_lens)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: not bitwise "
                                     f"equal run to run")
            n_valid = int(seq_lens.sum())
            errs.append(compare(f"{name} B={B} H={H}/{Hkv} Dh={Dh} W={W} "
                                f"({n_valid} rows) {dn}", got,
                                paged_attention_plain(*args), dn))
            timed = args
        args = timed
        rows["paged_attention"].append(_row(
            errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
            time_ms(torch, lambda: paged_attention_plain(*args)),
            paged_bound_ms(args, n_valid, "bfloat16"),
            f"{name} B={B} H={H} Hkv={Hkv} Dh={Dh} W={W} bf16, {n_valid} "
            f"valid K/V rows (the ring as a pool of one {W}-row block a "
            f"row)"))
        del timed, args
        _free(torch)
    for name, rs in rows.items():
        for r in rs:
            _log_row(name, r)
    return rows


def mla_megastep(torch, S):
    """The megastep at deepseek-v3's latent layout (w_post (73728, 7168),
    E_log 256 + 32 redundant, top-8): a decode step (B=8), one with a
    window, masked and lost experts and a dead replica, and a chunk step
    (B=40).  bf16 holds the whole bank of 288 experts (25.4 GB); f32 a
    third of it (96 experts at offset 96, the rest foreign).  Returns its
    timed rows and its route stage's (``route_stage_row``)."""
    from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                     decode_megastep_plain)
    W = DEEPSEEK
    log("kernels: decode_megastep at deepseek-v3's latent layout vs its "
        "plain version")
    cases = [
        ("decode", dict(B=S["max_batch"])),
        ("decode, window 64, masked 10/200, lost 5, dead replica of 1",
         dict(B=S["max_batch"], window=64, masked=(10, 200), lost=(5,),
              dead=(1,))),
        ("chunk step", dict(B=S["chunk"] + S["max_batch"])),
    ]
    errs, rows, route_rows = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        bank = (dict(e_local=W["E_log"] + W["R"], off=0)
                if dtype is torch.bfloat16 else dict(e_local=96, off=96))
        for i, (name, case) in enumerate(cases):
            args, kw, n_valid = megastep_case(torch, S, dtype=dtype,
                                              seed=70 + i, W=W, **bank,
                                              **case)
            y, h2, route = decode_megastep_cuda(*args, **kw,
                                                return_route=True)
            y2, h22 = decode_megastep_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h2, h22)):
                raise AssertionError(f"decode_megastep latent {name}: not "
                                     f"bitwise equal run to run")
            B = args[0].shape[0]
            errs += check_megastep(f"latent {name} B={B} (bank "
                                   f"{kw['e_local']} at {args[16]})", args,
                                   kw, y, h2, route, dn)
            timed = dtype is torch.bfloat16 and name in MEGA_TIMED
            if timed:
                route_rows.append(route_stage_row(
                    torch, lambda: decode_megastep_cuda(*args, **kw), args,
                    kw, route, h2))
            del y, y2, h2, h22
            if timed:
                mega = lambda: decode_megastep_cuda(*args, **kw)  # noqa
                bound = megastep_bound_ms(args, kw, route, n_valid, dn)
                rows.append(_row(
                    errs, time_ms(torch, mega),
                    time_ms(torch, lambda: decode_megastep_plain(*args,
                                                                 **kw)),
                    bound[:2],
                    f"B={B} D=7168 H=128 Hkv=1 Da=576 E=256+32 F=2048 "
                    f"Fs=2048 k=8 cap={kw['cap']} bf16, {n_valid} valid "
                    f"latent rows, {bound[2]} experts / {bound[3]} slots "
                    f"live"))
                log(f"  decode_megastep's launches at latent B={B}, one call "
                    f"in order (torch.profiler; route_slots is the route "
                    f"stage):")
                for us, key in kernel_sequence(torch, mega):
                    log(f"    {us:9.2f} us  {key[:90]}")
            del args, route
            _free(torch)
    return rows, route_rows


def mla_flash(torch):
    """Whole-prompt attention at MLA's widths (QK 192, V 128, H = Hkv =
    128) at the serial path's buckets, with and without window 6."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    H, Dq, Dv = DEEPSEEK["H"], 192, 128
    log("kernels: flash_prefill at deepseek-v3's MLA widths (B=1, H=Hkv="
        "128, Dq=192, Dv=128) vs its plain version")
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for Sq in (256, 512):
            for window in (0, 6):
                gen = torch.Generator(device="cuda").manual_seed(Sq + window)
                q, k, v = (torch.randn((1, Sq, H, d), generator=gen,
                                       device="cuda").to(dtype)
                           for d in (Dq, Dq, Dv))
                pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window)
                got = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                again = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_prefill MLA S={Sq}: not "
                                         f"bitwise equal run to run")
                errs.append(compare(
                    f"MLA S={Sq} window {window} {dn}", got,
                    flash_prefill_plain(q, k, v, pos, pos, **kw), dn,
                    FLASH_TOL))
                if not window and dtype is torch.bfloat16:
                    timed[Sq] = (q, k, v, pos)
    rows = []
    for Sq, (q, k, v, pos) in timed.items():
        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)

        def kernel():
            return flash_prefill_cuda(q, k, v, pos, pos)

        rows.append(_row(
            errs, time_ms(torch, kernel),
            time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos, pos)),
            flash_bound_ms(Sq, H, H, Dq, 0, q.element_size(), "bfloat16",
                           Dv=Dv),
            f"B=1 S={Sq} H=Hkv=128 Dq=192 Dv=128 causal bf16 (library: "
            f"scaled_dot_product_attention)", time_ms(torch, library)))
        log(f"  flash_prefill's kernels at MLA S={Sq} (torch.profiler, mean "
            f"of 20 calls, L2 warm):")
        for us, key in kernel_breakdown(torch, kernel):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed
    _free(torch)
    return rows


def mla_moe_fused(torch, S):
    """The fused MoE at deepseek-v3's widths: T = 8 and 40 tokens routed
    over 288 physical experts, top-8, D=7168, F=2048; bf16 with the whole
    bank, f32 with the 96 experts at offset 96 (the rest foreign)."""
    from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
    from repro_torch.models.moe import capacity
    W = DEEPSEEK
    E = W["E_log"] + W["R"]
    log("kernels: moe_fused at deepseek-v3's widths vs its plain version")
    errs, rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        e_local, off = (E, 0) if dtype is torch.bfloat16 else (96, 96)
        for T in (S["max_batch"], S["chunk"] + S["max_batch"]):
            args, kw = moe_case(
                torch, T=T, E=E, e_local=e_local, off=off, D=W["D"],
                Fd=W["F"], k=W["k"], cap=capacity(T * W["k"], E, 1.25),
                dtype=dtype, seed=80 + T, direct=True)
            got = moe_fused_cuda(*args, **kw)
            again = moe_fused_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_fused deepseek T={T}: not bitwise "
                                     f"equal run to run")
            _, _, live_e, live_s = moe_bound_ms(args, kw, dn)
            errs.append(compare(
                f"deepseek T={T} bank {e_local} at {off} ({live_e} experts, "
                f"{live_s} slots) {dn}", got, moe_fused_plain(*args, **kw),
                dn))
            del got, again
            if dtype is torch.bfloat16:
                bound, by, live_e, live_s = moe_bound_ms(args, kw, dn)
                rows.append(_row(
                    errs, time_ms(torch, lambda: moe_fused_cuda(*args, **kw)),
                    time_ms(torch, lambda: moe_fused_plain(*args, **kw)),
                    (bound, by),
                    f"T={T} D=7168 F=2048 E=288 k=8 cap={kw['cap']} bf16, "
                    f"{live_e} experts / {live_s} slots live"))
                moe_breakdown(torch, lambda: moe_fused_cuda(*args, **kw), T)
            del args
            _free(torch)
    return rows


def mla_expert_ffn(torch):
    """The serial path's expert FFN at deepseek-v3's widths: 288 experts
    (bf16; 96 in f32) of D=7168, F=2048 over capacity buffers of C=8 (a
    decode step), 9 and 18 (prefill buckets 256 and 512)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,
                                                expert_ffn_plain)
    W = DEEPSEEK
    D, Fd = W["D"], W["F"]
    log("kernels: expert_ffn at deepseek-v3's widths vs its plain version")

    def library(x, g, u, d):    # the closest torch.bmm chain
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)

    errs, rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        E = W["E_log"] + W["R"] if dtype is torch.bfloat16 else 96
        for C in ((8,) if dtype is torch.float32 else (8, 9, 18)):
            args = expert_ffn_args(torch, C, dtype, E=E, W=W)
            got = expert_ffn_cuda(*args)
            again = expert_ffn_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"expert_ffn deepseek C={C}: not "
                                     f"bitwise equal run to run")
            errs.append(compare(f"deepseek E={E} C={C} D={D} F={Fd} {dn}",
                                got, expert_ffn_plain(*args), dn, FFN_TOL))
            del got, again
            if dtype is torch.bfloat16:
                el = args[0].element_size()
                nbytes = el * (3 * E * D * Fd + 2 * E * C * D)
                flops = 6 * E * C * D * Fd
                t_b, t_o = (nbytes / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS["bfloat16"])
                rows.append(_row(
                    errs, time_ms(torch, lambda: expert_ffn_cuda(*args)),
                    time_ms(torch, lambda: expert_ffn_plain(*args)),
                    (1e3 * max(t_b, t_o),
                     "bytes" if t_b >= t_o else "operations"),
                    f"E={E} C={C} D={D} F={Fd} bf16 (library: silu(bmm) * "
                    f"bmm, then bmm)", time_ms(torch, lambda: library(*args))))
            del args
            _free(torch)
    return rows


# -- phase 4: model, card against CPU -------------------------------------------

BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash_prefill_bwd's cases: (name, B, S, H, Hkv, Dq, Dv, window); the
# first is the train path's shape (qwen2-moe-a2.7b, B 4, S 256), timed
FLASH_BWD_SHAPES = (
    ("qwen train", 4, 256, QWEN["H"], QWEN["Hkv"], 128, 128, 0),
    ("qwen window 6", 4, 256, QWEN["H"], QWEN["Hkv"], 128, 128, 6),
    ("internlm2-20b G=6", 1, 256, INTERNLM["H"], INTERNLM["Hkv"], 128, 128,
     0),
    ("mla Dq=192 Dv=128", 1, 256, 128, 128, 192, 128, 0))
# expert_ffn_bwd at the train path's capacity buffer: 64 experts of
# qwen2-moe-a2.7b, C = 80 (4 x 256 tokens, top-4, capacity factor 1.25),
# the rows from EMPTY_FROM on empty in every expert (dropped copies)
FFN_BWD = dict(E=64, C=80, EMPTY_FROM=70)
# ssm_scan_bwd's cases: (name, B, S, d_inner, with h_final's gradient),
# N 16; the first is the train_ssm path's shape (falcon-mamba-7b, B 4, S
# 256), timed; S 200 is not a multiple of the kernel's 32-step chunk
SSM_BWD_SHAPES = (
    ("falcon train", 4, 256, FALCON["d_inner"], False),
    ("falcon S=200 with dh", 2, 200, FALCON["d_inner"], True),
    ("jamba d=16384", 4, 256, 2 * FALCON["d_inner"], False))
# f32 operations per (row, step, channel, state): the forward's step
# recomputed (6, the exp counted once) and the reverse step (18)
SSM_BWD_OPS = 24


def _scaled_err(name, got, want, dn):
    """|got - want| <= BWD_TOL * (the gradient's largest |value|)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    ok = bool(g.isfinite().all()) and err <= BWD_TOL[dn] * scale
    log(f"  {name:<44} max_abs_err {err:.3e} at scale {scale:.3e} "
        f"(tol {BWD_TOL[dn]:g} of it)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} at scale {scale}")
    return err


def flash_bwd_bound_ms(B, S, H, Hkv, Dq, Dv, window, el, dn):
    """Bytes: q, k, v, o and dO read once, dq, dk, dv written once;
    operations: the five products of the backward (S = q k^T, dP = dO
    v^T, dV = P^T dO, dQ = dS k, dK = dS^T q) over the (query, key) pairs
    the causal mask and window leave visible."""
    i = np.arange(S)
    visible = int(np.minimum(i + 1, window).sum() if window
                  else (i + 1).sum())
    nbytes = el * B * S * 2 * (H + Hkv) * (Dq + Dv)
    flops = 2 * B * visible * H * (3 * Dq + 2 * Dv)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dn]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ffn_bwd_bound_ms(E, C, live, D, Fd, el, dn):
    """Bytes: x, the three weights and dy read once, dx and the three
    weight gradients written once; operations: the eight products (a, b
    and dh recomputed or formed, dx's two, dgate, dup, ddown) over the
    ``live`` rows of each expert (an empty row adds nothing)."""
    nbytes = el * (3 * E * C * D + 6 * E * D * Fd)
    flops = 8 * 2 * E * live * D * Fd
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dn]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ssm_bwd_bound_ms(args, dy, dh):
    """Bytes: u, dt, A, B, C, dy (and dh) read once, du, ddt, dA, dB and
    dC written once; operations: SSM_BWD_OPS f32 operations per (row,
    step, channel, state)."""
    u, _, A, _, _ = args
    B, S, d = u.shape
    N = A.shape[1]
    el = u.element_size()
    nbytes = (2 * (2 * B * S * d * el + 2 * B * S * N * el + d * N * 4)
              + dy.numel() * 4 + (0 if dh is None else dh.numel() * 4))
    flops = SSM_BWD_OPS * B * S * d * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def kernels_ssm_bwd(torch):
    """ssm_scan_bwd against its written-out plain version on the card at
    SSM_BWD_SHAPES, f32 (BWD_TOL 1e-4 of each gradient's scale) and bf16
    (2e-2), each run twice and bitwise equal; timed at the train_ssm
    path's shape beside its bound and the plain version (no library call
    computes a selective scan's gradient)."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda,
                                              ssm_scan_bwd_plain)
    log("kernels: ssm_scan_bwd vs ssm_scan_bwd_plain on the card (N 16)")
    N = FALCON["N"]
    errs, rows = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, S, d, with_dh) in enumerate(SSM_BWD_SHAPES):
            args = ssm_case(torch, B, S, with_h0=False, dtype=dtype,
                            seed=60 + i, d=d)[:5]
            gen = torch.Generator(device="cuda").manual_seed(70 + i)
            dy = torch.randn((B, S, d), generator=gen, device="cuda")
            dh = (torch.randn((B, d, N), generator=gen, device="cuda")
                  if with_dh else None)
            got = ssm_scan_bwd_cuda(*args, dy, dh)
            again = ssm_scan_bwd_cuda(*args, dy, dh)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"ssm_scan_bwd {name}: not bitwise "
                                     f"equal run to run")
            want = ssm_scan_bwd_plain(*args, dy, dh)
            for gname, g, w, x in zip(("du", "ddt", "dA", "dB", "dC"), got,
                                      want, args):
                if g.dtype != x.dtype:
                    raise AssertionError(f"ssm_scan_bwd {gname}: {g.dtype}")
                errs.append(_scaled_err(f"{name} B={B} S={S} {gname} {dn}",
                                        g, w, dn))
            del got, again, want
            if i:
                continue
            rows[dn] = _row(
                errs, time_ms(torch, lambda: ssm_scan_bwd_cuda(*args, dy)),
                time_ms(torch, lambda: ssm_scan_bwd_plain(*args, dy)),
                ssm_bwd_bound_ms(args, dy, None),
                f"B={B} S={S} d={d} N={N} {dn} (library: none, no PyTorch "
                f"call computes a selective scan's gradient)")
            log(f"  ssm_scan_bwd's kernels in {dn} (torch.profiler, mean of "
                f"20 calls, L2 warm):")
            for us, key in kernel_breakdown(
                    torch, lambda: ssm_scan_bwd_cuda(*args, dy)):
                log(f"    {us:9.2f} us  {key[:90]}")
        del args, dy, dh
        _free(torch)
    return dict(rows["float32"], bf16=rows["bfloat16"])


def kernels_backward(torch):
    """The three backward kernels (new in the port: repro differentiates
    its jnp functions and its lax.scan) against their written-out plain
    versions on the card, in f32 (BWD_TOL 1e-4 of each gradient's scale)
    and bf16 (2e-2), each run twice and bitwise equal: flash_prefill_bwd
    at FLASH_BWD_SHAPES, expert_ffn_bwd at FFN_BWD with empty rows (their
    gradients zero), ssm_scan_bwd at SSM_BWD_SHAPES.  Timed at the train
    paths' shapes in f32 (their type) and bf16, beside the bound and
    ``torch.autograd.grad`` of the same output through
    ``scaled_dot_product_attention`` and through the ``silu(bmm) * bmm``
    then ``bmm`` chain (their backward alone: the graph is kept)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_bwd_cuda,
                                                expert_ffn_bwd_plain,
                                                expert_ffn_cuda)
    from repro_torch.kernels.flash_prefill import (flash_prefill_bwd_cuda,
                                                   flash_prefill_bwd_plain,
                                                   flash_prefill_cuda)
    out = {}
    log("kernels: flash_prefill_bwd vs flash_prefill_bwd_plain on the card")
    errs, rows = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, S, H, Hkv, Dq, Dv, window) in enumerate(
                FLASH_BWD_SHAPES):
            gen = torch.Generator(device="cuda").manual_seed(40 + i)
            q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(
                dtype) for s in ((B, S, H, Dq), (B, S, Hkv, Dq),
                                 (B, S, Hkv, Dv), (B, S, H, Dv)))
            pos = torch.arange(S, dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=window)
            o = flash_prefill_cuda(q, k, v, pos, pos, **kw)
            got = flash_prefill_bwd_cuda(q, k, v, o, do, pos, pos, **kw)
            again = flash_prefill_bwd_cuda(q, k, v, o, do, pos, pos, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_prefill_bwd {name}: not bitwise "
                                     f"equal run to run")
            want = flash_prefill_bwd_plain(q, k, v, o, do, pos, pos, **kw)
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                errs.append(_scaled_err(f"{name} S={S} {gname} {dn}", g, w,
                                        dn))
            del got, again, want
            if i:
                continue
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True)
            do_t = do.transpose(1, 2)
            bound = flash_bwd_bound_ms(B, S, H, Hkv, Dq, Dv, window,
                                       q.element_size(), dn)
            rows[dn] = _row(
                errs, time_ms(torch, lambda: flash_prefill_bwd_cuda(
                    q, k, v, o, do, pos, pos)),
                time_ms(torch, lambda: flash_prefill_bwd_plain(
                    q, k, v, o, do, pos, pos)), bound,
                f"B={B} S={S} H=Hkv={H} Dh={Dq} causal {dn} (library: "
                f"autograd.grad through scaled_dot_product_attention)",
                time_ms(torch, lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), do_t, retain_graph=True)))
            del qt, kt, vt, o_lib
        _free(torch)
    out["flash_prefill_bwd"] = dict(rows["float32"], bf16=rows["bfloat16"])

    log(f"kernels: expert_ffn_bwd vs expert_ffn_bwd_plain on the card "
        f"(E={FFN_BWD['E']}, C={FFN_BWD['C']}, D={QWEN['D']}, "
        f"F={QWEN['F']}, rows from {FFN_BWD['EMPTY_FROM']} empty)")
    E, C, cut = FFN_BWD["E"], FFN_BWD["C"], FFN_BWD["EMPTY_FROM"]
    D, Fd = QWEN["D"], QWEN["F"]
    errs, rows = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x, g, u, d = expert_ffn_args(torch, C, dtype, E=E)
        x[:, cut:] = 0
        dy = torch.randn((E, C, D), generator=torch.Generator(
            device="cuda").manual_seed(50), device="cuda").to(dtype)
        got = expert_ffn_bwd_cuda(x, g, u, d, dy)
        again = expert_ffn_bwd_cuda(x, g, u, d, dy)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("expert_ffn_bwd: not bitwise equal run to "
                                 "run")
        if got[0][:, cut:].any():
            raise AssertionError("expert_ffn_bwd: an empty row's dx is not 0")
        want = expert_ffn_bwd_plain(x, g, u, d, dy)
        for gname, a, w in zip(("dx", "dgate", "dup", "ddown"), got, want):
            errs.append(_scaled_err(f"E={E} C={C} {gname} {dn}", a, w, dn))
        del got, again, want
        ts = [t.detach().requires_grad_() for t in (x, g, u, d)]
        y_lib = torch.bmm(F.silu(torch.bmm(ts[0], ts[1]))
                          * torch.bmm(ts[0], ts[2]), ts[3])
        rows[dn] = _row(
            errs, time_ms(torch, lambda: expert_ffn_bwd_cuda(x, g, u, d, dy)),
            time_ms(torch, lambda: expert_ffn_bwd_plain(x, g, u, d, dy)),
            ffn_bwd_bound_ms(E, C, cut, D, Fd, x.element_size(), dn),
            f"E={E} C={C} ({cut} live rows) D={D} F={Fd} {dn} (library: "
            f"autograd.grad through silu(bmm) * bmm, then bmm)",
            time_ms(torch, lambda: torch.autograd.grad(
                y_lib, ts, dy, retain_graph=True)))
        log(f"  expert_ffn_bwd's kernels in {dn} (torch.profiler, mean of "
            f"20 calls, L2 warm):")
        for us, key in kernel_breakdown(
                torch, lambda: expert_ffn_bwd_cuda(x, g, u, d, dy)):
            log(f"    {us:9.2f} us  {key[:90]}")
        del x, g, u, d, dy, ts, y_lib
        _free(torch)
    out["expert_ffn_bwd"] = dict(rows["float32"], bf16=rows["bfloat16"])
    out["ssm_scan_bwd"] = kernels_ssm_bwd(torch)
    for name, r in out.items():
        _log_row(name, r)
        _log_row(name + " (bf16)", r["bf16"])
    return out


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_model(torch, seed):
    """qwen2-moe-a2.7b and deepseek-v3 (MLA) at full width, 2 layers,
    f32, card against CPU; then falcon-mamba-7b; then one period of
    jamba-1.5-large-398b; then the dense family's internlm2-20b (GQA, G =
    6) and minicpm3-4b (MLA, Da 288)."""
    import dataclasses
    from repro_torch.configs import get_config
    lap = laps("model")
    model_moe(torch, dataclasses.replace(
        get_config(QWEN_ARCH), num_layers=2, moe_impl="fused"), seed,
        "qwen2-moe-a2.7b full width, 2 layers")
    lap(QWEN_ARCH)
    ds = get_config("deepseek-v3")
    # a 288-expert f32 layer is 50.7 GB: this phase alone cuts the bank
    # (its routing keeps top-8); every width stays
    cut = dataclasses.replace(ds, num_layers=2, moe_impl="fused",
                              moe=dataclasses.replace(
                                  ds.moe, first_k_dense=1, num_experts=16,
                                  num_redundant_experts=4))
    model_moe(torch, cut, seed,
              f"deepseek-v3 full width (d_model {ds.d_model}, "
              f"{ds.num_heads} MLA heads, latent "
              f"{ds.mla.kv_lora_rank} + {ds.mla.qk_rope_head_dim}, dense "
              f"d_ff {ds.moe.dense_d_ff}, expert d_ff "
              f"{ds.moe.expert_d_ff}, vocab {ds.vocab_size}), 2 layers (1 "
              f"dense + 1 MoE), bank cut from {ds.moe.num_experts} + "
              f"{ds.moe.num_redundant_experts} to 16 + 4 experts, top-"
              f"{ds.moe.top_k} kept")
    lap("deepseek-v3")
    model_ssm(torch, seed)
    lap("falcon-mamba-7b")
    model_hybrid(torch, seed)
    lap("jamba-1.5-large-398b")
    model_ring(torch, seed)
    lap("ring")
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        heads = (f"{cfg.num_heads} MLA heads, latent "
                 f"{cfg.mla.kv_lora_rank} + {cfg.mla.qk_rope_head_dim}"
                 if cfg.attention_type == "mla" else
                 f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads "
                 f"of {cfg.head_dim}")
        model_moe(torch, dataclasses.replace(cfg, num_layers=2), seed,
                  f"{arch} full width (d_model {cfg.d_model}, {heads}, "
                  f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), 2 layers, "
                  f"dense", impls=("composed",))
        lap(arch)


def model_moe(torch, base, seed, what, impls=IMPLS):
    """One attention+MoE (or dense) config, card against CPU: a chunk step
    and a decode step per decode implementation of ``impls``, then the
    serial prefill.  The f32 weights are drawn on the card and copied to
    the CPU: drawn on the CPU, qwen2-moe-a2.7b's took 14.2 s and
    deepseek-v3's 27.2 s of the time limit on the H100's host."""
    import dataclasses
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    bs, nblk, max_blk, width, batch = 16, 16, 4, 32, 8
    trash = nblk
    t0 = time.perf_counter()
    p_card = Model(base, torch.float32, device="cuda").init(seed)
    p_cpu = _map(p_card, lambda t: t.cpu())
    log(f"model: {what}, f32; weights from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    # chunk: request A = 20 prompt tokens (blocks 0-1), B = 9 (block 2),
    # rows 29-31 idle; decode: A in slot 0, B in slot 3, others idle
    lens, blocks = {"a": 20, "b": 9}, {"a": [0, 1], "b": [2]}
    prompts = {n: rng.integers(0, base.vocab_size, L)
               for n, L in lens.items()}
    tok = np.zeros(width, np.int32)
    tables = np.zeros((width, max_blk), np.int32)
    seq = np.zeros(width, np.int32)
    wb = np.full(width, trash, np.int32)
    wo = np.zeros(width, np.int32)
    row, last = 0, {}
    for n in ("a", "b"):
        for pos in range(lens[n]):
            tok[row] = prompts[n][pos]
            tables[row, :len(blocks[n])] = blocks[n]
            seq[row], wb[row], wo[row] = pos + 1, blocks[n][pos // bs], \
                pos % bs
            last[n] = row
            row += 1
    chunk_page = dict(tables=tables, seq_lens=seq, write_bid=wb,
                      write_off=wo)
    rows = [last["a"], last["b"]]
    slots = {"a": 0, "b": 3}
    live = [slots["a"], slots["b"]]
    card_logits = {}
    for impl in impls:
        cfg = dataclasses.replace(base, decode_impl=impl)
        cpu = Model(cfg, torch.float32, device="cpu")
        card = Model(cfg, torch.float32, device="cuda")
        caches = {"cpu": cpu.init_paged_cache(width, nblk, bs),
                  "cuda": card.init_paged_cache(width, nblk, bs)}
        models = {"cpu": (cpu, p_cpu), "cuda": (card, p_card)}

        def both(tokens, page):
            res = {}
            for dev, (m, p) in models.items():
                tt = torch.from_numpy(tokens).to(dev)
                pg = {k: torch.from_numpy(v).to(dev) for k, v in page.items()}
                logits, _ = m.decode_step_paged(p, caches[dev], tt, pg)
                res[dev] = logits.float().cpu().numpy()
            err = float(np.abs(res["cuda"] - res["cpu"]).max())
            if not np.isfinite(res["cuda"]).all() or err > MODEL_LOGIT_ATOL:
                raise AssertionError(f"model {impl} logits: card vs CPU "
                                     f"max_abs_err {err} > "
                                     f"{MODEL_LOGIT_ATOL}")
            return res, err

        launches.clear()
        res_c, err_c = both(tok, chunk_page)
        greedy = res_c["cpu"][rows].argmax(-1)
        if not (res_c["cuda"][rows].argmax(-1) == greedy).all():
            raise AssertionError(f"model {impl}: chunk-step greedy tokens "
                                 f"differ")
        dtok = np.zeros(batch, np.int32)
        dt = np.zeros((batch, max_blk), np.int32)
        ds = np.zeros(batch, np.int32)
        dwb = np.full(batch, trash, np.int32)
        dwo = np.zeros(batch, np.int32)
        for n, g in zip(("a", "b"), greedy):
            s, pos = slots[n], lens[n]
            dtok[s] = g
            dt[s, :len(blocks[n])] = blocks[n]
            ds[s], dwb[s], dwo[s] = pos + 1, blocks[n][pos // bs], pos % bs
        res_d, err_d = both(dtok, dict(tables=dt, seq_lens=ds, write_bid=dwb,
                                       write_off=dwo))
        if not (res_d["cuda"][live].argmax(-1)
                == res_d["cpu"][live].argmax(-1)).all():
            raise AssertionError(f"model {impl}: decode-step greedy tokens "
                                 f"differ")
        path = impl if base.moe is not None else "dense"
        used = [k for k, paths in KERNEL_PATH.items() if path in paths]
        if min(launches.get(k, 0) for k in used) <= 0:
            raise AssertionError(f"model {impl}: kernel launches "
                                 f"{dict(launches)}")
        log(f"  {impl}: logits card vs CPU: chunk max_abs_err {err_c:.3e}, "
            f"decode {err_d:.3e} (atol {MODEL_LOGIT_ATOL:g}); greedy tokens "
            f"equal ({greedy.tolist()} -> "
            f"{res_d['cpu'][live].argmax(-1).tolist()}); launches "
            f"{dict(launches)}")
        card_logits[impl] = (res_c["cuda"], res_d["cuda"])
        del models, cpu, card, caches
        gc.collect()
        torch.cuda.empty_cache()
    if len(impls) > 1:
        model_impls_agree(card_logits, rows, live)
    model_prefill(torch, base, p_cpu, p_card, seed)
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def model_impls_agree(card_logits, rows, live):
    """The megakernel and composed logits on the card agree."""
    (mc, md), (cc, cd) = card_logits["megakernel"], card_logits["composed"]
    err = max(float(np.abs(mc - cc).max()), float(np.abs(md - cd).max()))
    same = ((mc[rows].argmax(-1) == cc[rows].argmax(-1)).all()
            and (md[live].argmax(-1) == cd[live].argmax(-1)).all())
    log(f"  megakernel vs composed on the card: max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); greedy tokens {'equal' if same else 'DIFFER'}")
    if err > MODEL_LOGIT_ATOL or not same:
        raise AssertionError("model: megakernel and composed disagree")


def model_prefill(torch, base, p_cpu, p_card, seed):
    """The serial path's model calls, card against CPU: one whole-prompt
    prefill of 200 tokens (bucket 256) with the dense-scatter MoE, its
    K/V (MLA: latent) rows installed into the pools, then one decode step
    on top."""
    import dataclasses
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.serving import cache_ops
    from repro_torch.serving.executor import next_bucket
    from repro_torch.serving.kvcache import padded_block_ids
    cfg = dataclasses.replace(base, moe_impl="gather_psum",
                              decode_impl="composed")
    bs, nblk, max_blk, batch, n = 16, 20, 16, 8, 200
    bucket = next_bucket(n, 512)
    blocks = list(range(nblk - 1, nblk - 1 - (n + bs) // bs, -1))
    bids = padded_block_ids(blocks, bucket // bs, nblk)
    rng = np.random.default_rng(seed + 1)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    page = dict(tables=np.zeros((batch, max_blk), np.int32),
                seq_lens=np.zeros(batch, np.int32),
                write_bid=np.full(batch, nblk, np.int32),
                write_off=np.zeros(batch, np.int32))
    page["tables"][0, :len(blocks)] = blocks
    page["seq_lens"][0] = n + 1
    page["write_bid"][0], page["write_off"][0] = blocks[n // bs], n % bs
    launches.clear()
    res = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        cache = m.init_paged_cache(batch, nblk, bs)
        axes = cache_ops.infer_paged_axes(m, nblk, bs)
        last, raw = m.prefill_paged(p, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        cache_ops.install_prefill(cache, raw, axes, bids, 0)
        last = last.float().cpu().numpy()
        if dev == "cpu":
            first = int(last[0].argmax())
        tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        tok[0] = first
        logits, _ = m.decode_step_paged(
            p, cache, tok, {k: torch.from_numpy(v).to(dev)
                            for k, v in page.items()})
        rows = {f"{g}/{key}": pool[:, blocks].float().cpu().numpy()
                for g in cache for key, pool in cache[g].items()}
        res[dev] = (last, rows, logits.float().cpu().numpy()[:1])
        del m, cache, raw
    (lc, rc, dc), (lg, rg, dg) = res["cpu"], res["cuda"]
    errs = {"last logits": float(np.abs(lg - lc).max()),
            "installed " + "/".join(sorted({k.split("/")[1] for k in rc})):
                max(float(np.abs(rg[k] - rc[k]).max()) for k in rc),
            "decode logits": float(np.abs(dg - dc).max())}
    greedy = (int(lg[0].argmax()) == first
              and int(dg[0].argmax()) == int(dc[0].argmax()))
    counts = {k: launches.get(k, 0) for k in ("flash_prefill", "expert_ffn",
                                              "paged_attention")
              if k != "expert_ffn" or cfg.moe is not None}
    log(f"  serial prefill ({n} tokens, bucket {bucket}"
        + (", dense-scatter MoE" if cfg.moe is not None else "")
        + "), card vs CPU: " + ", ".join(f"{k} max_abs_err {v:.3e}"
                                          for k, v in errs.items())
        + f" (atol {MODEL_LOGIT_ATOL:g}); greedy tokens "
        f"{'equal' if greedy else 'DIFFER'} ({first} -> "
        f"{int(dc[0].argmax())}); launches {counts}")
    if max(errs.values()) > MODEL_LOGIT_ATOL or not greedy \
            or not all(np.isfinite(lg).ravel()):
        raise AssertionError("model: the serial prefill disagrees")
    if min(counts.values()) <= 0:
        raise AssertionError(f"model: serial prefill launches {counts}")


def model_ssm(torch, seed):
    """The ssm path's model calls, card against CPU: falcon-mamba-7b at
    full width, 2 layers, f32; one whole-prompt prefill of 200 tokens at
    bucket 256, its final state installed into slot 2 of 8, then two
    greedy decode steps."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.serving import cache_ops
    from repro_torch.serving.executor import next_bucket
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=2)
    batch, nblk, bs, slot, n = 8, 4, 16, 2, 200
    bucket = next_bucket(n, 512)
    t0 = time.perf_counter()
    p_card = Model(cfg, torch.float32, device="cuda").init(seed)
    p_cpu = _map(p_card, lambda t: t.cpu())
    log(f"model: falcon-mamba-7b full width, 2 layers, f32; weights from "
        f"seed {seed} in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 2)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    page = dict(tables=np.zeros((batch, 1), np.int32),
                seq_lens=np.zeros(batch, np.int32),
                write_bid=np.full(batch, nblk, np.int32),
                write_off=np.zeros(batch, np.int32))
    launches.clear()
    res = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        cache = m.init_paged_cache(batch, nblk, bs)
        axes = cache_ops.infer_paged_axes(m, nblk, bs)
        last, raw = m.prefill_paged(p, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        # a state-only cache: no pool rows, so every block id is trash
        cache_ops.install_prefill(cache, raw, axes,
                                  np.full(bucket // bs, nblk), slot)
        # a copy: on the CPU .float().cpu() is the cache itself, which
        # the decode steps below update in place
        state = {k: v[:, slot].float().cpu().clone().numpy()
                 for k, v in cache["layers"].items()}
        logits = [last.float().cpu().numpy()[0]]
        if dev == "cpu":
            greedy = [int(logits[0].argmax())]
        for step in range(2):
            tok = torch.zeros(batch, dtype=torch.int32, device=dev)
            tok[slot] = greedy[step]
            page["seq_lens"][slot] = n + 1 + step
            out, _ = m.decode_step_paged(
                p, cache, tok, {k: torch.from_numpy(v).to(dev)
                                for k, v in page.items()})
            logits.append(out.float().cpu().numpy()[slot])
            if dev == "cpu":
                greedy.append(int(logits[-1].argmax()))
        res[dev] = (logits, state)
        del m, cache, raw
    (lc, sc), (lg, sg) = res["cpu"], res["cuda"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(lg, lc))
    atol, rtol = STATE_TOL
    state_err = {k: float(np.abs(sg[k] - sc[k]).max()) for k in sc}
    state_ok = all(np.allclose(sg[k], sc[k], atol=atol, rtol=rtol)
                   for k in sc)
    same = [int(a.argmax()) for a in lg] == greedy
    count = launches.get("ssm_scan", 0)
    log(f"  ssm prefill ({n} tokens, bucket {bucket}) + 2 decode steps, "
        f"card vs CPU: logits max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); installed state max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in state_err.items())
        + f" (atol {atol:g}, rtol {rtol:g}); greedy tokens "
        f"{'equal' if same else 'DIFFER'} ({greedy}); launches "
        f"{{'ssm_scan': {count}}}")
    if err > MODEL_LOGIT_ATOL or not state_ok or not same \
            or not all(np.isfinite(a).all() for a in lg):
        raise AssertionError("model: the ssm prefill and decode disagree")
    if count != 3 * cfg.num_layers:   # one a layer, on the card's calls
        raise AssertionError(f"model: ssm_scan launches {count}")
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def model_hybrid(torch, seed):
    """The hybrid path's model calls, card against CPU: one period of
    jamba-1.5-large-398b at full width in f32 (attention at sublayer 4,
    seven Mamba sublayers, the fused MoE on the odd ones), weights drawn
    on the card; one whole-prompt prefill of 200 tokens at bucket 256,
    its K/V rows and seven states installed into slot 2 of 8, then two
    greedy decode steps.  The bank is cut to 2 + 0 experts (top-2 kept)
    for this check alone: at 4 experts the f32 period is 65 GB."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.serving import cache_ops
    from repro_torch.serving.executor import next_bucket
    from repro_torch.serving.kvcache import padded_block_ids
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(
        full, num_layers=full.hybrid_period, moe_impl="fused",
        moe=dataclasses.replace(full.moe, num_experts=2,
                                num_redundant_experts=0))
    bs, nblk, max_blk, batch, slot, n = 16, 20, 16, 8, 2, 200
    bucket = next_bucket(n, 512)
    blocks = list(range(nblk - 1, nblk - 1 - (n + 2 + bs) // bs, -1))
    bids = padded_block_ids(blocks, bucket // bs, nblk)
    log(f"model: before jamba-1.5-large-398b's f32 period, {host_memory()}")
    t0 = time.perf_counter()
    p_card = Model(cfg, torch.float32, device="cuda").init(seed)
    p_cpu = _map(p_card, lambda t: t.cpu())
    log(f"model: jamba-1.5-large-398b full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_inner {cfg.mamba.expand * cfg.d_model}, "
        f"d_ff {cfg.d_ff}, expert d_ff {cfg.moe.expert_d_ff}, vocab "
        f"{cfg.vocab_size}), one "
        f"period of {cfg.hybrid_period} sublayers, bank cut from "
        f"{full.moe.num_experts} + {full.moe.num_redundant_experts} to 2 + "
        f"0 experts, top-{cfg.moe.top_k} kept, f32; weights from seed "
        f"{seed} in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(seed + 3)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    page = dict(tables=np.zeros((batch, max_blk), np.int32),
                seq_lens=np.zeros(batch, np.int32),
                write_bid=np.full(batch, nblk, np.int32),
                write_off=np.zeros(batch, np.int32))
    page["tables"][slot, :len(blocks)] = blocks
    launches.clear()
    res = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        cache = m.init_paged_cache(batch, nblk, bs)
        axes = cache_ops.infer_paged_axes(m, nblk, bs)
        last, raw = m.prefill_paged(p, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        cache_ops.install_prefill(cache, raw, axes, bids, slot)
        entry = cache["periods"]
        installed = {f"attn/{k}": v[:, blocks].float().cpu().clone().numpy()
                     for k, v in entry["attn"].items()}
        installed.update({f"ssm/{k}": v[:, :, slot].float().cpu().clone()
                          .numpy() for k, v in entry["ssm"].items()})
        logits = [last.float().cpu().numpy()[0]]
        if dev == "cpu":
            greedy = [int(logits[0].argmax())]
        for step in range(2):
            pos = n + step
            tok = torch.zeros(batch, dtype=torch.int32, device=dev)
            tok[slot] = greedy[step]
            page["seq_lens"][slot] = pos + 1
            page["write_bid"][slot] = blocks[pos // bs]
            page["write_off"][slot] = pos % bs
            out, _ = m.decode_step_paged(
                p, cache, tok, {k: torch.from_numpy(v).to(dev)
                                for k, v in page.items()})
            logits.append(out.float().cpu().numpy()[slot])
            if dev == "cpu":
                greedy.append(int(logits[-1].argmax()))
        res[dev] = (logits, installed)
        del m, cache, raw
    (lc, ic), (lg, ig) = res["cpu"], res["cuda"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(lg, lc))
    atol, rtol = STATE_TOL
    state_err = {k: float(np.abs(ig[k] - ic[k]).max()) for k in ic}
    state_ok = all(np.allclose(ig[k], ic[k], atol=atol, rtol=rtol)
                   for k in ic)
    same = [int(a.argmax()) for a in lg] == greedy
    counts = {k: launches.get(k, 0) for k in
              ("flash_prefill", "paged_attention", "ssm_scan", "moe_fused")}
    log(f"  hybrid prefill ({n} tokens, bucket {bucket}) + 2 decode steps, "
        f"card vs CPU: logits max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); installed pool rows and states "
        f"max_abs_err " + ", ".join(f"{k} {v:.3e}"
                                   for k, v in state_err.items())
        + f" (atol {atol:g}, rtol {rtol:g}); greedy tokens "
        f"{'equal' if same else 'DIFFER'} ({greedy}); launches {counts}")
    if err > MODEL_LOGIT_ATOL or not state_ok or not same \
            or not all(np.isfinite(a).all() for a in lg):
        raise AssertionError("model: the hybrid prefill and decode disagree")
    # on the card's calls: one prefill and two decode steps, through one
    # attention sublayer, seven Mamba sublayers and four MoE sublayers
    want = {"flash_prefill": 1, "paged_attention": 2, "ssm_scan": 21,
            "moe_fused": 12}
    if counts != want:
        raise AssertionError(f"model: hybrid launches {counts}, expected "
                             f"{want}")
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


RING_ARCHS = ("internvl2-26b", "seamless-m4t-large-v2")


def model_ring(torch, seed):
    """The ring serve step (``Model.prefill``, ``decode_step``), card
    against CPU in f32: every registered arch at its smoke config, then
    internvl2-26b and seamless-m4t-large-v2 at full width, 2 layers (the
    audio's 2 encoder and 2 decoder layers), weights drawn on the card."""
    import dataclasses
    from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
    for arch in ALL_ARCHS:
        ring_card_vs_cpu(torch, get_smoke_config(arch), seed,
                         f"{arch} smoke", "cpu")
    for arch in RING_ARCHS:
        cfg = get_config(arch)
        cut = dataclasses.replace(cfg, num_layers=2, encoder_layers=min(
            cfg.encoder_layers, 2))
        ring_card_vs_cpu(torch, cut, seed,
                         f"{arch} full width (d_model {cfg.d_model}, "
                         f"{cfg.num_heads} heads over {cfg.num_kv_heads} "
                         f"KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
                         f"vocab {cfg.vocab_size}), 2 layers"
                         + (", 2 encoder layers over "
                            f"{cfg.encoder_seq} frames"
                            if cfg.family == "audio" else
                            f", {cfg.num_patches} patches"), "cuda")


def ring_inputs(cfg, seed, n_text):
    """numpy inputs of the ring serve step, a row per entry of ``n_text``
    (its real text tokens): ``tokens`` (B, max(n_text)), ``lengths`` (a
    vlm row's counting its patches), a vlm's ``patches`` and an audio
    model's ``frames`` from N(0, 1)."""
    rng = np.random.default_rng(seed)
    B, extra = len(n_text), cfg.num_patches if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, max(n_text)))
             .astype(np.int32),
             "lengths": (extra + np.asarray(n_text)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model), np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), np.float32)
    return batch


def ring_launches(model, steps):
    """The attention, scan and MoE launches of one prefill and ``steps``
    ring decode steps: a flash_prefill per attention layer (encoder's
    and decoder's) and per cross-attention layer, a paged_attention per
    decoder attention and cross layer and step, an ssm_scan per Mamba
    layer and call, an expert kernel per MoE layer and call."""
    n = {"attn": 0, "mamba": 0, "moe": 0, "cross": 0, "enc": 0}
    for name, L, mixer, ffn_kind, cross in model.layer_groups():
        if mixer == "hybrid":
            for _, mx, fk in model.period_sublayers():
                n[mx] += L
                n["moe"] += L * (fk == "moe")
            continue
        n["enc" if name == "enc_layers" else mixer] += L
        n["moe"] += L * (ffn_kind == "moe")
        n["cross"] += L * cross
    calls = steps + 1
    return {"flash_prefill": n["attn"] + n["enc"] + n["cross"],
            "paged_attention": steps * (n["attn"] + n["cross"]),
            "ssm_scan": calls * n["mamba"], "moe": calls * n["moe"]}


def ring_card_vs_cpu(torch, cfg, seed, what, init_on, steps=4):
    """``prefill`` of 2 rows (the second 5 tokens shorter) into rings of
    the prompt + 8 slots, then ``steps`` greedy ``decode_step``s, on the
    card and on the CPU from the same f32 weights (drawn on
    ``init_on``); the card's steps take the CPU's tokens.  Logits within
    MODEL_LOGIT_ATOL, greedy tokens equal, and the card's launches those
    of :func:`ring_launches`."""
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    t0 = time.perf_counter()
    if init_on == "cpu":
        p_cpu = Model(cfg, torch.float32, device="cpu").init(seed)
        p_card = _map(p_cpu, lambda t: t.to("cuda"))
    else:
        p_card = Model(cfg, torch.float32, device="cuda").init(seed)
        p_cpu = _map(p_card, lambda t: t.cpu())
    init_s = time.perf_counter() - t0
    batch = ring_inputs(cfg, seed + 4, [16, 11])
    max_seq = int(batch["lengths"][0]) + 8
    tokens, res = [], {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        launches.clear()
        last, cache = m.prefill(p, {k: torch.from_numpy(v).to(dev)
                                    for k, v in batch.items()},
                                max_seq=max_seq)
        out = [last.float().cpu().numpy()]
        for i in range(steps):
            if dev == "cpu":
                tokens.append(out[-1][:, :cfg.vocab_size].argmax(-1)
                              .astype(np.int32))
            last, cache = m.decode_step(p, cache,
                                        torch.from_numpy(tokens[i]).to(dev))
            out.append(last.float().cpu().numpy())
        res[dev] = out
        del cache
    counts = {k: v for k, v in launches.items() if v}
    want = ring_launches(m, steps)
    got = dict(counts, moe=counts.get("moe_fused", 0)
               + counts.get("expert_ffn", 0))
    bad_counts = {k: (got.get(k, 0), v) for k, v in want.items()
                  if got.get(k, 0) != v}
    err = max(float(np.abs(a - b).max())
              for a, b in zip(res["cuda"], res["cpu"]))
    greedy = [a[:, :cfg.vocab_size].argmax(-1).tolist() for a in res["cuda"]]
    same = greedy[:steps] == [t.tolist() for t in tokens]
    log(f"model: ring serve step, {what}, f32 (weights from seed {seed} on "
        f"{init_on} in {init_s:.1f} s): prefill of "
        f"{batch['lengths'].tolist()} positions + {steps} decode steps, "
        f"card vs CPU logits max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); greedy tokens "
        f"{'equal' if same else 'DIFFER'}; launches {counts}")
    if (err > MODEL_LOGIT_ATOL or not same or bad_counts
            or not all(np.isfinite(a).all() for a in res["cuda"])):
        raise AssertionError(f"model: ring serve step of {what}: err {err}, "
                             f"greedy {'equal' if same else 'DIFFER'}, "
                             f"launches (got, want) {bad_counts}")
    del p_card, p_cpu, m
    _free(torch)


# -- phase 5: engine --------------------------------------------------------------

def _prompts(vocab, seed):
    """Four prompts of 128-256 tokens, then four more that each share the
    leading 64 tokens (4 blocks) of one of the first four."""
    rng = np.random.default_rng(seed)
    first = [list(map(int, rng.integers(0, vocab, int(n))))
             for n in rng.integers(128, 257, 4)]
    later = [p[:64] + list(map(int, rng.integers(0, vocab, int(n) - 64)))
             for p, n in zip(first, rng.integers(128, 257, 4))]
    return first, later


def _spec_prompts(vocab, seed):
    """Four prompts, each a random 16-token pattern repeated to 128-256
    tokens (the n-gram proposer drafts from the prompt), then four more,
    each one of the four patterns repeated to another length (its leading
    blocks are in the prefix cache)."""
    rng = np.random.default_rng(seed + 1)
    pats = [list(map(int, rng.integers(0, vocab, 16))) for _ in range(4)]

    def rep(pat):
        return (pat * 16)[:int(rng.integers(128, 257))]
    return [rep(p) for p in pats], [rep(p) for p in pats]


def _serve(torch, eng, vocab, seed, new_tokens, on_step=None, prompts=None,
           sync=True):
    """Serve the 8 prompts (the later 4 after two steps) to the end;
    ``on_step(eng)`` runs after every step.  ``prompts``: (first, later),
    ``_prompts`` by default.  ``sync``: a ``torch.cuda.synchronize()``
    after every step; without it, one at the end (the overlap pipeline's
    steps must not be serialized by the measurement).  Tokens are counted
    as committed (an overlap step's guesses are not yet)."""
    first, later = prompts or _prompts(vocab, seed)
    reqs = [eng.submit(p, new_tokens) for p in first]
    steps = []      # (seconds, new tokens, prefill tokens, recovered)
    computed = lambda: eng.prefill_stats()[  # noqa: E731
        "prefill_tokens_computed"]

    def recoveries():   # a background role switch's step is one too
        return len(eng.reports) + len(eng.background_reports)

    def committed():
        return sum(len(r.committed_output) for r in eng.all_requests)

    def one():
        n0 = committed()
        c0 = computed()
        r0 = recoveries()
        t0 = time.perf_counter()
        eng.step()
        if sync:
            torch.cuda.synchronize()
        if on_step is not None:
            on_step(eng)
        steps.append((time.perf_counter() - t0, committed() - n0,
                      computed() - c0, recoveries() > r0))

    t_all = time.perf_counter()
    one()
    one()
    reqs += [eng.submit(p, new_tokens) for p in later]
    for _ in range(2000):
        if not eng.unfinished:
            break
        one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    dec = [(s, n) for s, n, c, rec in steps if c == 0 and not rec and n]
    tok_s = sum(n for _, n in dec) / max(sum(s for s, _ in dec), 1e-9)
    total = sum(len(r.output_tokens) for r in reqs)
    return reqs, dict(steps=len(steps), wall_s=wall, out_tokens=total,
                      e2e_tok_s=total / wall, decode_tok_s=tok_s,
                      decode_steps=len(dec))


def _trace(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only, so the
    host pays little for it); print the kernels that took the most
    device time and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  trace: device busy {busy:.3f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.1f}%); {sum(r[1] for r in rows)} device "
        f"ops; top by device time:")
    for us, n, key in rows[:15]:
        log(f"    {us / 1e3:10.2f} ms {n:7d}x  {key[:100]}")
    # the rows PERF.md's attention, scan and copy figures read
    log("  of which attention, the scan and copies:")
    for us, n, key in rows:
        if any(k in key for k in ("paged::", "scan_kernel", "step_kernel",
                                  "copy", "Memcpy")):
            log(f"    {us / 1e3:10.2f} ms {n:7d}x  {key[:100]}")
    return out


def phase_engine(torch, seed, layers, paths, profile=False):
    """Serve each path twice, without and with a fault (``disagg``: three
    times; ``fleet``: once, with its three events; ``http``: one drill of
    the launcher).  The paths of one architecture and depth share one
    workdir (the first writes ``weights.npz``, the others load it),
    removed before
    the next group writes its own.  Returns the kernels' launch counts,
    each summed over the paths it runs on, and each per path."""
    log(f"engine: before the first build, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
        f"card")
    counts, by_path, rates, streams = {}, {}, {}, {}
    # streams a later path compares with: (path, "fault") for a faulted
    # run's, ("spec", "plain") for the plain engine on the pattern prompts
    # the tp path reuses the train path's model, weights and batches
    kept = {"tp_train": "tp" in paths}
    groups, group_of = {}, {}
    for p in paths:
        group_of[p] = (PATH_ARCH.get(p, QWEN_ARCH), PATH_LAYERS.get(p, layers))
        groups.setdefault(group_of[p], []).append(p)
    lap = laps("engine")
    for (arch, depth), group in groups.items():
        workdir = ROOT / "build" / f"smoke_engine_{arch}_{depth}"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            cfg = engine_config(arch, depth)
            for path in group:
                serve = SERVE.get(path, serve_path)
                extra = ({"reference": streams.get("composed")}
                         if path == "fleet" else
                         {} if serve is serve_disagg else {"kept": kept})
                path_counts, path_rates, path_streams = serve(
                    torch, cfg, path, workdir, seed, profile, **extra)
                # what the path's closures kept alive (reference cycles
                # between engines and their hooks) goes before the next
                # path builds
                gc.collect()
                torch.cuda.empty_cache()
                if path_rates is not None:
                    rates[path], streams[path] = path_rates, path_streams
                for k, v in path_counts.items():
                    counts[k] = counts.get(k, 0) + v
                    by_path.setdefault(k, {})[path] = v
                lap(f"path {path}")
        finally:
            # what a path kept for a later path of its group
            kept.pop("qwen_bf16", None)
            kept.pop("qwen_f32", None)
            if kept.pop("nccl", None) is not None:
                import torch.distributed as dist
                dist.destroy_process_group()
            shutil.rmtree(workdir, ignore_errors=True)
        lap(f"{arch} at {depth} layers: workdir removed")
    for path, (clean, fault) in rates.items():
        log(f"engine {path}: decode tokens/s "
            f"{clean['decode_tok_s']:.3f} without the fault, "
            f"{fault['decode_tok_s']:.3f} with it; end-to-end tokens/s "
            f"{clean['e2e_tok_s']:.3f} and {fault['e2e_tok_s']:.3f}")
    # bf16 rounds in another order on each path, so greedy streams may
    # part; the f32 model phase is where tokens must match
    for other in streams:
        base = "mla_composed" if other.startswith("mla") else "composed"
        # the speculation paths serve other prompts (their own print)
        if (other in (base, "ssm", "spec", "spec_megakernel")
                or base not in streams
                or group_of[other] != group_of[base]):
            continue
        pairs = list(zip(streams[other], streams[base]))
        same = sum(a == b for m, c in pairs for a, b in zip(m, c))
        prefix = sum(next((i for i, (a, b) in enumerate(zip(m, c))
                           if a != b), min(len(m), len(c)))
                     for m, c in pairs)
        log(f"engine: the {other} run shares {same} of "
            f"{sum(len(c) for c in streams[base])} greedy output "
            f"tokens with the {base} run, position by position "
            f"({prefix} in the requests' common prefixes; not checked)")
    return counts, by_path


def engine_config(arch, layers):
    """qwen2-moe-a2.7b at full width and depth ``layers``; deepseek-v3 at
    full width with its depth cut from 61 to MLA_DENSE_LAYERS dense layers
    and 1 MoE layer; falcon-mamba-7b, internlm2-20b and
    jamba-1.5-large-398b at full width and depth ``layers`` (Jamba's bank
    cut to HYBRID_EXPERTS)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family == "vlm":
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers, "
            f"width kept (internlm2-20b's backbone, ~0.78 GB of bf16 a "
            f"layer)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family in ("vlm", "audio"):
        log(f"engine: {cfg.name}: {cfg.num_layers} decoder layers"
            + (f" after {cfg.encoder_layers} encoder layers over "
               f"{cfg.encoder_seq} frames" if cfg.family == "audio" else
               f" after {cfg.num_patches} patch embeddings")
            + f", d_model {cfg.d_model}, {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}")
        return cfg
    if cfg.attention_type == "mla":
        depth = MLA_DENSE_LAYERS + 1
        log(f"engine: depth cut from {cfg.num_layers} to {depth} layers "
            f"({MLA_DENSE_LAYERS} of its {cfg.moe.first_k_dense} dense + 1 "
            f"MoE), width kept: at full width one MoE layer holds 25.4 GB "
            f"of experts, and the start-up file is ~31 GB of the 45 GiB a "
            f"run may write")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_k_dense=MLA_DENSE_LAYERS))
        layers = depth
    if cfg.family == "dense":
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers, "
            f"width kept (~0.78 GB of bf16 a layer plus 2.3 GB of embedding "
            f"and head)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        log(f"engine: {cfg.name}: {cfg.num_layers} dense layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} "
            f"KV heads of {cfg.head_dim}, d_ff {cfg.d_ff} "
            f"({cfg.activation}), vocab {cfg.vocab_size}")
        return cfg
    if cfg.moe is None:
        mb = cfg.mamba
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers, "
            f"width kept (~0.23 GB of bf16 a layer)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        log(f"engine: {cfg.name}: {cfg.num_layers} Mamba layers, d_model "
            f"{cfg.d_model}, d_inner {mb.expand * cfg.d_model}, d_state "
            f"{mb.d_state}, d_conv {mb.d_conv}, dt_rank "
            f"{mb.resolved_dt_rank(cfg.d_model)}, vocab {cfg.vocab_size}")
        return cfg
    if cfg.hybrid_period:
        m = cfg.moe
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers "
            f"({layers // cfg.hybrid_period} period), width kept; the bank "
            f"cut from {m.num_experts} + {m.num_redundant_experts} to "
            f"{HYBRID_EXPERTS} + 0 experts a MoE sublayer, top-{m.top_k} "
            f"kept: one expert is 3 x {cfg.d_model} x {m.expert_d_ff} bf16 "
            f"= 1.208 GB, the config's bank 38.65 GB a MoE sublayer and "
            f"154.6 GB a period, over the card's 80 GB")
        cfg = dataclasses.replace(
            cfg, num_layers=layers, moe=dataclasses.replace(
                m, num_experts=HYBRID_EXPERTS, num_redundant_experts=0))
        mb = cfg.mamba
        log(f"engine: {cfg.name}: {cfg.num_layers} sublayers (attention at "
            f"{cfg.hybrid_attn_index}, Mamba elsewhere; MoE on the odd "
            f"ones, a dense FFN on the others), d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
            f"{cfg.head_dim}, d_inner {mb.expand * cfg.d_model}, d_state "
            f"{mb.d_state}, dt_rank {mb.resolved_dt_rank(cfg.d_model)}, "
            f"d_ff {cfg.d_ff}, expert d_ff {cfg.moe.expert_d_ff}, "
            f"{cfg.moe.num_experts}+0 experts, top-{cfg.moe.top_k}, vocab "
            f"{cfg.vocab_size}")
        return cfg
    if layers != cfg.num_layers and cfg.attention_type != "mla":
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers, "
            f"width kept (start-up writes ~1.2 GB of checkpoint a layer)")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    m = cfg.moe
    heads = (f"{cfg.num_heads} MLA heads (q rank {cfg.mla.q_lora_rank}, "
             f"latent {cfg.mla.kv_lora_rank} + rope "
             f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim})"
             if cfg.attention_type == "mla"
             else f"{cfg.num_heads}x{cfg.head_dim} heads")
    log(f"engine: {cfg.name}: {cfg.num_layers} layers "
        f"({m.first_k_dense} dense of d_ff {m.dense_d_ff}), d_model "
        f"{cfg.d_model}, {heads}, "
        f"{m.num_experts}+{m.num_redundant_experts} experts of d_ff "
        f"{m.expert_d_ff}, {m.num_shared_experts} shared, top-{m.top_k}, "
        f"vocab {cfg.vocab_size}")
    return cfg


def host_memory() -> str:
    """The host's MemTotal and MemAvailable, from /proc/meminfo."""
    try:
        info = dict(line.split(":", 1) for line in
                    Path("/proc/meminfo").read_text().splitlines())
    except OSError:
        return "host memory: /proc/meminfo unreadable"
    gib = {k: int(info[k].split()[0]) / 2**20
           for k in ("MemTotal", "MemAvailable") if k in info}
    return "host " + ", ".join(f"{k} {v:.1f} GiB" for k, v in gib.items())


def make_engine(torch, cfg, path, workdir, seed, policy, dtype=None,
                **over):
    """One engine of ``path`` (2 attention ranks, bf16 unless ``dtype``)
    in ``workdir``, its options changed by ``over``; prints its start-up,
    which must write no per-rank shard file."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    t0 = time.perf_counter()
    ec = dict(mode="collocated", num_dp=2, max_batch=8, max_seq=512,
              block_size=16, num_blocks=256, seed=seed, workdir=str(workdir),
              policy=policy)
    ec.update(PATHS[path])
    ec.update(over)
    eng = InferenceEngine(cfg, EngineConfig(**ec), dtype=dtype)
    files = {str(f.relative_to(workdir)): f.stat().st_size
             for f in workdir.rglob("*") if f.is_file()}
    disk = sum(files.values())
    shards = [f for f in files if Path(f).name.startswith("expert_shard_")]
    if shards:
        raise AssertionError(f"engine {path}: start-up wrote shard files "
                             f"{shards}")
    log(f"  engine up in {time.perf_counter() - t0:.1f} s; {eng.dtype} "
        f"weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card "
        f"(peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB); "
        f"start-up files {disk / 1e9:.2f} GB on disk ("
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in files.items()
                    if v > 1e6)
        + f", no expert_shard_*.npz); {host_memory()}; "
        f"moe_impl {eng.cfg.moe_impl!r}; init_timings " + json.dumps(
            {k: round(v, 4) for k, v in eng.init_timings.items()}))
    return eng


def serve_path(torch, cfg, path, workdir, seed, profile, kept):
    """One engine path: 8 requests without a fault, then with an L6 fault
    on physical 1 mid-step at step 6 (``attn+moe`` on an MoE model, where
    the lost experts are masked; ``attn`` on the ssm path), revived in
    place, on a second engine (``FAULT_ON_SAME_ENGINE``: on the first,
    its prefix cache dropped).  Returns (launch counts of the faulted
    run, (clean, fault) rates, the clean run's output streams); the
    faulted run's streams go to ``kept``."""
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    new_tokens = 32

    def make():
        return make_engine(torch, cfg, path, workdir, seed,
                           RecoveryPolicy(allow_role_switch=False))

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    eng = make()
    serve = lambda: _serve(torch, eng, cfg.vocab_size,  # noqa: E731
                           seed, new_tokens)
    reqs, clean = _trace(torch, serve) if profile else serve()
    if any(r.state.value != "finished" for r in reqs) or eng.reports:
        raise AssertionError(f"engine {path} (no fault): not every request "
                             f"finished")
    streams = [list(r.output_tokens) for r in reqs]
    log("  no fault: " + json.dumps(
        {k: round(v, 3) for k, v in clean.items()}))
    del reqs
    if path in FAULT_ON_SAME_ENGINE:
        for ex in eng.dp_executors:
            ex.block_manager.drop_cached()
        log("  the faulted run is served on the same engine, once the "
            "clean run has drained and its prefix cache is dropped (no "
            "second build)")
    else:
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        eng = make()
    schedule_fault(eng, cfg)
    before = eng.prefill_stats()
    launches.clear()
    reqs, fault = _serve(torch, eng, cfg.vocab_size, seed, new_tokens)
    path_counts = dict(launches)
    kept[path, "fault"] = [list(r.output_tokens) for r in reqs]
    log("  with fault: " + json.dumps(
        {k: round(v, 3) for k, v in fault.items()}))
    used = check_revived(eng, cfg, path, reqs, path_counts, before)
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: path_counts[k] for k in used}, (clean, fault), streams


def schedule_fault(eng, cfg):
    """The L6 fault of every path's faulted run: physical 1, mid-step at
    the run's step 6 (``attn+moe`` on an MoE model, ``attn`` on the ssm
    path)."""
    from repro_torch.core.fault_codes import Severity
    eng.injector.schedule(eng.step_no + 6, 1, severity=Severity.L6,
                          component="attn+moe" if cfg.moe is not None
                          else "attn", mid_step=True)


def check_revived(eng, cfg, path, reqs, path_counts, before=None):
    """The checks of a run with the step-6 L6 fault on physical 1: every
    request finished, the fault revived in place (an MoE model's lost
    experts masked, ``moe+missing_experts``; the ssm path's ``attn``) on
    a "precompiled" graph, the prefix cache hit where prompts chunk, and
    every kernel of the path launched.  ``before``: the engine's
    ``prefill_stats()`` when the run began (its counts are cumulative).
    Returns the path's kernels."""
    moe = cfg.moe is not None
    states = [r.state.value for r in reqs]
    if any(s != "finished" for s in states):
        raise AssertionError(f"engine {path} (fault): requests {states}")
    if not eng.reports:
        raise AssertionError(f"engine {path}: the fault was not handled")
    rep = eng.reports[0]
    log(f"  recovery: {rep.summary()}")
    log("  recovery timings " + json.dumps(
        {k: round(v, 6) for k, v in rep.timings.items()}))
    if moe:
        # rank 1 held the upper half of the physical slots; the redundant
        # slots replicate the first logicals, so the logicals from half
        # the physical count on lost every copy
        mask = eng.runtime.expert_mask.cpu().numpy()
        masked = [int(e) for e in np.flatnonzero(~mask)]
        lost = list(range(
            (cfg.moe.num_experts + cfg.moe.num_redundant_experts) // 2,
            cfg.moe.num_experts))
        if rep.scenario != "moe+missing_experts" or masked != lost:
            raise AssertionError(f"engine {path}: scenario {rep.scenario}, "
                                 f"masked {masked}")
        what = f"logical experts {masked[0]}-{masked[-1]} masked"
        if cfg.moe.first_k_dense and not any(
                a.startswith("dense-FFN TP group") for a in rep.actions):
            raise AssertionError(f"engine {path}: no dense-FFN TP group "
                                 f"action in {rep.actions}")
    else:
        if rep.scenario != "attn" or rep.migrated < 1:
            raise AssertionError(f"engine {path}: scenario {rep.scenario}, "
                                 f"migrated {rep.migrated}")
        what = "no experts"
    if rep.compile_source != "precompiled":
        raise AssertionError(f"engine {path}: compile_source "
                             f"{rep.compile_source}")
    stats = {k: v - (before or {}).get(k, 0)
             for k, v in eng.prefill_stats().items()}
    hits = stats["prefix_cache_hits"]
    # whole-prompt installs (serial, or a model that cannot chunk) bypass
    # the prefix cache
    if (eng.ecfg.admission == "chunked"
            and eng.model.supports_chunked_prefill and hits <= 0):
        raise AssertionError(f"engine {path}: the prefix cache was never "
                             f"hit")
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(path_counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine {path}: kernel launches {path_counts}")
    log(f"  scenario {rep.scenario}, {what}, compile_source "
        f"{rep.compile_source}, migrated {rep.migrated}, prefix_cache_hits "
        f"{hits}, prefill tokens {stats['prefill_tokens_computed']}, "
        f"launches {path_counts}; actions {rep.actions}")
    return used


SWITCH_ACTION = re.compile(r"role switch: dp(\d+) -> moe ep-rank (\d+); "
                           r"migrated (\d+) of its sequences "
                           r"\((\d+) KV-streamed\)")


def _watch_imports(torch, eng, streamed, what="disagg"):
    """Wrap each attention rank's ``import_kv_blocks``: after an install,
    the target's pool rows at the request's new blocks must be
    ``torch.equal`` to the payload, on the card.  Appends (request id,
    payload bytes) to ``streamed``."""
    from repro_torch.serving.cache_ops import gather_request_blocks

    def watch(ex):
        install = ex.import_kv_blocks

        def checked(req, kv):
            if not install(req, kv):
                return False
            live = [b for b in ex.scheduler.block_tables[req.req_id]
                    .blocks[:kv.num_blocks] if b != ex.trash_block]
            rows, _ = gather_request_blocks(ex.cache, ex.paged_axes, live,
                                            req.batch_slot)
            for got, sent in zip(rows, kv.pool_blocks):
                if got is None:
                    continue
                if sent.device.type != "cuda" or not torch.equal(got, sent):
                    raise AssertionError(
                        f"engine {what}: request {req.req_id}'s installed "
                        f"rows differ from its payload on {sent.device}")
            streamed.append((req.req_id, kv.nbytes()))
            return True

        ex.import_kv_blocks = checked

    for ex in eng.dp_executors:
        watch(ex)


def serve_disagg(torch, cfg, path, workdir, seed, profile):
    """The disaggregated path (physicals 0-1 attention, 2-3 experts, EP
    rank j on physical 2 + j), three runs of the 8 requests: (1) without a
    fault; (2) an L6 ``moe`` fault mid-step on physical 2 one step after
    run 1 had every request past its prefill: a synchronous role switch,
    the donor's residents KV-streamed to the other attention rank and EP
    rank 0's 32 physical experts read back from ``weights.npz``; (3) the
    same fault with ``background_role_switch``: logicals 4-31 masked at
    once, the switch finished at the top of the next step.  Returns
    (launch counts of run 2, (run 1, run 2) rates, run 1's streams)."""
    from repro_torch.core.fault_codes import Severity
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    new_tokens = 32
    m = cfg.moe
    per = (m.num_experts + m.num_redundant_experts) // 2
    lost = list(range(m.num_redundant_experts, per))  # no replica on rank 1

    def make(policy):
        eng = make_engine(torch, cfg, path, workdir, seed, policy)
        pids = [x.physical_id for x in eng.moe_executors]
        if pids != [2, 3]:
            raise AssertionError(f"engine disagg: expert ranks {pids}")
        return eng, eng.expert_integrity()[0]

    def release():   # after the caller dropped its engine
        gc.collect()
        torch.cuda.empty_cache()

    def finished(reqs, what):
        states = [r.state.value for r in reqs]
        if any(s != "finished" for s in states):
            raise AssertionError(f"engine disagg ({what}): requests {states}")

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    eng, _ = make(RecoveryPolicy())
    ready = []      # steps after which all 8 requests are past prefill

    def note_ready(e):
        if len(e.all_requests) == 8 and all(r.output_tokens
                                            for r in e.all_requests):
            ready.append(e.step_no)

    serve = lambda: _serve(torch, eng, cfg.vocab_size,  # noqa: E731
                           seed, new_tokens, note_ready)
    reqs, clean = _trace(torch, serve) if profile else serve()
    finished(reqs, "no fault")
    if eng.reports:
        raise AssertionError(f"engine disagg: {len(eng.reports)} reports "
                             f"without a fault")
    streams = [list(r.output_tokens) for r in reqs]
    computed = eng.prefill_stats()["prefill_tokens_computed"]
    fault_step = ready[0] + 1
    log(f"  no fault: " + json.dumps({k: round(v, 3)
                                      for k, v in clean.items()})
        + f"; every request past prefill after step {ready[0]}, so the "
        f"fault goes mid-step at step {fault_step}")
    del eng, reqs
    release()

    for kind, policy in (("sync", RecoveryPolicy()), (
            "background", RecoveryPolicy(background_role_switch=True))):
        eng, start = make(policy)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        eng.injector.schedule(fault_step, 2, severity=Severity.L6,
                              component="moe", mid_step=True)
        streamed, masked = [], []

        def note_mask(e):
            if e.reports and not e.background_reports and not masked:
                masked.extend(int(i) for i in np.flatnonzero(
                    ~e.runtime.expert_mask.cpu().numpy()))

        _watch_imports(torch, eng, streamed)
        launches.clear()
        reqs, rates = _serve(torch, eng, cfg.vocab_size, seed, new_tokens,
                             note_mask)
        counts = dict(launches)
        finished(reqs, kind)
        if len(eng.reports) != 1:
            raise AssertionError(f"engine disagg ({kind}): "
                                 f"{len(eng.reports)} reports")
        rep = eng.reports[0]
        plan = rep.moe_plan
        checks, alive = eng.expert_integrity()
        log(f"  {kind} role switch: " + json.dumps(
            {k: round(v, 3) for k, v in rates.items()}))
        log(f"  recovery: {rep.summary()}")
        log(f"  recovery timings " + json.dumps(
            {k: round(v, 6) for k, v in rep.timings.items()})
            + f"; KV streamed {sum(b for _, b in streamed)} bytes in "
            f"{len(streamed)} payloads; actions {rep.actions}")
        bad = []
        if rep.scenario != "moe+role_switch" or plan.lost_logicals != lost:
            bad.append(f"scenario {rep.scenario}, lost "
                       f"{plan.lost_logicals if plan else None}")
        if rep.compile_source != "precompiled":
            bad.append(f"compile_source {rep.compile_source}")
        if not all(alive) or checks != start:
            bad.append(f"integrity {checks} {alive}, start-up {start}")
        owner = eng._shard_owner(0)
        if (owner is None or owner.shard is eng.shards[0]
                or eng._resident[0] is not owner.shard):
            bad.append("EP rank 0's bank slice is not the shard read "
                       "from disk")
        if kind == "sync":
            sw = next((SWITCH_ACTION.match(a) for a in rep.actions
                       if SWITCH_ACTION.match(a)), None)
            n, n_streamed = ((int(sw.group(3)), int(sw.group(4)))
                             if sw else (0, -1))
            if n < 1 or n_streamed != n or len(streamed) != n:
                bad.append(f"migrated {n}, KV-streamed {n_streamed}, "
                           f"installs checked {len(streamed)}")
            now = eng.prefill_stats()["prefill_tokens_computed"]
            if now > computed:
                bad.append(f"prefill tokens {now} > {computed} without "
                           f"the fault")
            if rep.timings.get("generator", 0.0) <= 0:
                bad.append("no reload timed")
            path_counts, fault = counts, rates
            log(f"  sync: donor dp{sw.group(1) if sw else '?'} migrated {n} "
                f"({n_streamed} KV-streamed), prefill tokens {now} (no "
                f"fault: {computed}), EP rank 0 checksum {checks[0]!r} = "
                f"start-up {start[0]!r}, launches {counts}")
        else:
            bg = eng.background_reports
            if (rep.timings.get("generator", 0.0) != 0.0
                    or rep.timings.get("role_switch", 0.0) != 0.0):
                bad.append(f"downtime timings {rep.timings}")
            if masked != lost:
                bad.append(f"masked during the switch {masked}")
            if not bg or bg[0]["restored_experts"] != float(per):
                bad.append(f"background reports {bg}")
            if (eng.expert_map.coverage() != 1.0
                    or not bool(eng.runtime.expert_mask.all())):
                bad.append("mask not cleared")
            log(f"  background: logicals {masked[0]}-{masked[-1]} masked "
                f"until the switch; its own timings "
                + json.dumps({k: round(v, 6) for k, v in bg[0].items()})
                + f"; KV streamed {sum(b for _, b in streamed)} bytes; "
                f"coverage {eng.expert_map.coverage()}, checksums equal "
                f"start-up {checks == start}")
        if bad:
            raise AssertionError(f"engine disagg ({kind}): " + "; ".join(bad))
        if kind == "background":
            # the restart baseline at this depth: the instance relaunched
            # in place (weights, pools and executors released, then
            # everything rebuilt from weights.npz)
            torch.cuda.reset_peak_memory_stats()
            n_timings = len(eng.graph_cache.timings)
            t0 = time.perf_counter()
            eng.full_reinit()
            _check_reinit(torch, eng, mem_before, n_timings,
                          time.perf_counter() - t0, "disagg")
        del eng, reqs, owner, note_mask
        release()
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(path_counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine disagg: kernel launches {path_counts}")
    return {k: path_counts[k] for k in used}, (clean, fault), streams


def _check_reinit(torch, eng, mem_before, n_timings, wall_s, what):
    """After ``eng.full_reinit()`` (peak memory statistics reset just
    before it): the card holds what it held before the fault, within 5%;
    the peak never held a second copy of the weights; the rebuilt decode
    graph is ``cached``.  Prints the Table-1 timings."""
    from repro_torch.training.checkpoint import flatten
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    weights = sum(t.nbytes for _, t in flatten(eng.params))
    rebuilt = [tm.source for tm in eng.graph_cache.timings[n_timings:]
               if tm.key[0] == "decode"]
    log(f"  full_reinit ({what}): {wall_s:.3f} s wall; Table-1 seconds "
        + json.dumps({k: round(v, 4) for k, v in eng.init_timings.items()})
        + f" (sum {sum(eng.init_timings.values()):.3f}); card memory "
        f"{mem_before / 2**30:.3f} GiB before the fault, {after / 2**30:.3f}"
        f" GiB after, peak {peak / 2**30:.3f} GiB (the weights: "
        f"{weights / 2**30:.3f} GiB); rebuilt decode graph {rebuilt}")
    bad = []
    if abs(after - mem_before) > 0.05 * mem_before:
        bad.append(f"card memory {after} B after, {mem_before} B before")
    if peak - mem_before > weights / 2:
        bad.append(f"peak {peak} B: the old weights were not released")
    if not rebuilt or rebuilt[0] != "cached":
        bad.append(f"rebuilt decode graph {rebuilt}")
    if bad:
        raise AssertionError(f"engine {what}: full_reinit: " + "; ".join(bad))


def serve_fleet(torch, cfg, path, workdir, seed, profile, reference=None):
    """The fleet path: ``repro_torch.fleet.build_fleet`` of 2 instances and
    1 spare on the card, each the composed engine of ``make_engine`` (2
    collocated ranks, bf16), serving the 8 prompts twice over (16
    requests of 32 new tokens).  First instance 0's redundant slots are
    re-pointed (``rebalance_experts``) at the experts its routing chose
    most over the first 3 ticks.  Then three faults, each an L6
    ``attn+moe`` fault mid-step with a forced decision
    (``arbiter.force_policy``): (1) physical 1 of instance 0, revived in
    place, then cleared and rejoined (EP rank 1 read back from
    ``weights.npz``, following the map); (2) physical 1 of instance 1,
    once its requests all decode: the spare takes its place, the
    residents of its reachable rank KV-streamed; (3) physical 0 of that
    spare, restarted (``full_reinit``).  Every engine samples a fixed
    virtual step for straggler detection (the wall-clock detector is not
    under test here).  ``reference``: the composed path's fault-free
    streams of the 8 prompts (served here when None).  Returns (launch
    counts of the fleet run, None, None)."""
    from repro_torch.core.fault_codes import Severity
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.fleet import RecoveryArbiter, build_fleet
    from repro_torch.kernels import launches
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.weights_util import expert_leaves
    new_tokens = 32
    policy = RecoveryPolicy(allow_role_switch=False)

    def fail(msg):
        raise AssertionError(f"engine fleet: {msg}")

    if profile:
        log("  fleet: not traced (--profile traces the single engines)")
    if reference is None:
        log("  fleet: one fault-free composed engine serves the 8 prompts "
            "first, for the comparison of greedy streams")
        eng = make_engine(torch, cfg, "composed", workdir, seed, policy)
        reqs, _ = _serve(torch, eng, cfg.vocab_size, seed, new_tokens)
        reference = [list(r.output_tokens) for r in reqs]
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    log(f"engine: path {path!r}: " + json.dumps(PATHS[path])
        + "; 2 instances + 1 spare")
    ec = dict(mode="collocated", num_dp=2, max_batch=8, max_seq=512,
              block_size=16, num_blocks=256, seed=seed, workdir=str(workdir),
              policy=policy)
    ec.update(PATHS[path])
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, EngineConfig(**ec), instances=2, spares=1,
                        device="cuda")
    standby = fleet.spares.warm[0]
    engines = [i.engine for i in fleet.instances.values()] + [standby.engine]
    for eng in engines:
        eng.virtual_step_s = 0.01
    arb = fleet.arbiter
    log(f"  fleet up in {time.perf_counter() - t0:.1f} s (3 engine builds);"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card; "
        f"init_timings " + json.dumps([{k: round(v, 3) for k, v in
                                        e.init_timings.items()}
                                       for e in engines])
        + f"; cost model from instance 0's: revive "
        f"{arb.cost.est_revive_s():.4f} s, restart "
        f"{arb.cost.est_restart_s():.4f} s a request")
    # the un-forced estimate of every decision, beside the forced one
    forced, shadow, unforced = arb.decide, RecoveryArbiter(arb.cost), []

    def decide(inst, event, **kw):
        unforced.append(shadow.decide(inst, event, **kw))
        return forced(inst, event, **kw)

    arb.decide = decide
    inst0, inst1 = fleet.instances[0], fleet.instances[1]
    eng0, eng1 = inst0.engine, inst1.engine
    first, later = _prompts(cfg.vocab_size, seed)
    prompts = (first + later) * 2
    launches.clear()
    t_all = time.perf_counter()
    reqs = [fleet.submit(p, new_tokens) for p in prompts]

    # usage counts from instance 0's routing over its first ticks
    usage = torch.zeros(cfg.moe.num_experts, dtype=torch.int64,
                        device="cuda")
    route = moe_mod.route

    def counted(router_w, x_flat, runtime, moe):
        w, sel = route(router_w, x_flat, runtime, moe)
        if runtime is eng0.runtime:
            usage.add_(torch.bincount(sel.reshape(-1),
                                      minlength=moe.num_experts))
        return w, sel

    moe_mod.route = counted
    try:
        for _ in range(3):
            fleet.tick()
    finally:
        moe_mod.route = route
    emap = eng0.expert_map

    def moved_equal_sources(moves):
        for slot, logical in moves.items():
            src = [r for r in emap.replicas_of(logical) if r != slot][0]
            for key, leaf in expert_leaves(eng0.params):
                if not torch.equal(leaf[:, slot], leaf[:, src]):
                    fail(f"slot {slot} ({key}) differs from its source "
                         f"slot {src}")

    if emap.E_phys == cfg.moe.num_experts:
        log("  rebalance skipped: instance 0's map has no redundant slots")
        moves = {}
    else:
        counts = usage.cpu().tolist()
        moves = eng0.rebalance_experts(counts)
        moved_equal_sources(moves)
        hot = sorted(range(len(counts)), key=lambda e: -counts[e])[:8]
        log(f"  rebalance of instance 0 from its routing ({sum(counts)} "
            f"selections; hottest {[(e, counts[e]) for e in hot]}): moves "
            f"{moves}, each re-pointed slot torch.equal to its source slot "
            f"on the card")

    def tick_until(done, limit, what):
        for _ in range(limit):
            if done():
                return
            fleet.tick()
        if not done():
            fail(f"{what} after {limit} ticks")

    # (1) revive in place, then the device rejoins
    start = eng0.expert_integrity()[0]
    arb.force_policy = "revive"
    n_rep = len(eng0.reports)
    eng0.injector.schedule(eng0.step_no + 1, 1, severity=Severity.L6,
                           component="attn+moe", mid_step=True)
    tick_until(lambda: len(eng0.reports) > n_rep, 20, "no revive")
    rep = eng0.reports[-1]
    if rep.compile_source != "precompiled":
        fail(f"revive compile_source {rep.compile_source}")
    log(f"  (1) revive: {rep.summary()}; Table-1 " + json.dumps(
        {k: round(v, 6) for k, v in rep.timings.items()}))
    eng0.injector.clear(1)
    t0 = time.perf_counter()
    if not eng0.rejoin_device(1):
        fail("physical 1 did not rejoin")
    torch.cuda.synchronize()
    rejoin_s = time.perf_counter() - t0
    back = eng0.expert_integrity()[0]
    if back != start:
        fail(f"checksums {back} after the rejoin, {start} before the fault")
    moved_equal_sources(moves)
    log(f"  rejoin of physical 1: {rejoin_s:.3f} s (EP rank 1 read back "
        f"from weights.npz, {len(emap.moved_slots(1))} re-pointed slots "
        f"from their logicals' columns); checksums {back} equal those "
        f"before the fault")

    # (2) the spare takes instance 1's place
    def decoding():
        live = [r for r in eng1.all_requests
                if r.state.value not in ("finished", "failed")]
        return bool(live) and all(r.output_tokens for r in live)

    tick_until(decoding, 400, "instance 1's requests never all decoded")
    streamed = []
    _watch_imports(torch, standby.engine, streamed, "fleet")
    arb.force_policy = "spare"
    moving = [r for r in eng1.all_requests
              if r.state.value not in ("finished", "failed")]
    n_ev = len(fleet.forensics)
    eng1.injector.schedule(eng1.step_no + 1, 1, severity=Severity.L6,
                           component="attn+moe", mid_step=True)
    tick_until(lambda: any(e["policy"] == "spare"
                           for e in fleet.forensics[n_ev:]), 20, "no spare")
    ev = next(e for e in fleet.forensics[n_ev:] if e["policy"] == "spare")
    if inst1.state.value != "dead" or ev["iid"] != standby.iid:
        fail(f"instance 1 {inst1.state.value}, spare event {ev}")
    kv_bytes = sum(b for _, b in streamed)
    log(f"  (2) spare {standby.iid} for instance 1: swap {ev['charged_s']} "
        f"s wall; {len(moving)} requests moved, {len(streamed)} "
        f"KV-streamed ({kv_bytes} bytes, each install torch.equal to its "
        f"payload), {len(moving) - len(streamed)} replayed; {ev['detail']}")
    if not streamed:
        fail("no request KV-streamed to the spare")

    # (3) restart the spare that took instance 1's place
    spare_eng = standby.engine
    for _ in range(2):
        fleet.tick()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_timings = len(spare_eng.graph_cache.timings)
    arb.force_policy = "restart"
    n_ev = len(fleet.forensics)
    spare_eng.injector.schedule(spare_eng.step_no + 1, 0,
                                severity=Severity.L6, component="attn+moe",
                                mid_step=True)
    tick_until(lambda: any(e["policy"] == "restart"
                           for e in fleet.forensics[n_ev:]), 20, "no restart")
    ev = next(e for e in fleet.forensics[n_ev:] if e["policy"] == "restart")
    log(f"  (3) restart of instance {standby.iid}: {ev['charged_s']} s wall "
        f"(FleetInstance.restart)")
    _check_reinit(torch, spare_eng, mem_before, n_timings, ev["charged_s"],
                  "fleet")

    tick_until(lambda: not fleet.unfinished, 3000, "requests unfinished")
    wall = time.perf_counter() - t_all
    counts = dict(launches)
    states = [r.state.value for r in reqs]
    if any(s_ != "finished" for s_ in states):
        fail(f"requests {states}")
    policies = [d.policy for d in arb.decisions]
    if policies != ["revive", "spare", "restart"]:
        fail(f"decisions {policies}")
    for d, u in zip(arb.decisions, unforced):
        log(f"  decision {d.policy} ({d.reason}); un-forced: {u.policy} "
            f"({u.reason}); estimates " + json.dumps(
                {k: round(v, 4) for k, v in sorted(u.est_cost.items())}))
    ttft = np.asarray(fleet.ttfts())
    total = sum(len(r.output_tokens) for r in reqs)
    log(f"  fleet: {len(reqs)} requests, {total} tokens in {wall:.3f} s: "
        f"{total / wall:.3f} tokens/s end to end; TTFT (virtual clock) p50 "
        f"{np.percentile(ttft, 50):.4f} s, p99 {np.percentile(ttft, 99):.4f}"
        f" s over {len(ttft)}; {fleet.ticks} ticks, virtual clock "
        f"{fleet.now_s:.3f} s")
    # bf16 and capacity drops make a token depend on the batch it ran in,
    # so the streams of requests that never moved are printed beside
    shared = {True: [], False: []}
    for i, r in enumerate(reqs):
        ref = reference[i % len(reference)]
        same = next((j for j, (a, b) in enumerate(
            zip(r.output_tokens, ref)) if a != b),
            min(len(ref), len(r.output_tokens)))
        moved = bool(r.cross_instance_migrations or r.migrations)
        shared[moved].append(same)
        log(f"    request {i} (prompt {i % len(reference)}, instances "
            f"{fleet.meta[r.req_id]['instances']}, migrations "
            f"{r.migrations}, recomputed {r.recomputed_tokens}): its first "
            f"{same} of {len(ref)} greedy tokens equal the fault-free "
            f"engine's (bf16; not checked)")
    log(f"  greedy tokens shared with the fault-free engine, position by "
        f"position from the first: migrated requests {shared[True]}, the "
        f"others {shared[False]}")
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        fail(f"kernel launches {counts}")
    log(f"  launches {counts}")
    return {k: counts[k] for k in used}, None, None


class SpecWatch:
    """Wraps an executor's ``compute`` to check the first partially
    rejected speculation window: the pool rows its rejected drafts wrote
    hold their pre-step bits after the step, and its row 0 write stands
    (as tests/test_spec_decode.py does)."""

    def __init__(self, torch, eng):
        from repro_torch.serving.cache_ops import capture_pool_rows
        self.torch, self.capture = torch, capture_pool_rows
        self.checked = None
        for ex in eng.dp_executors:
            ex.compute = self._wrap(ex, ex.compute)

    def _rows(self, ex, win):
        bs = ex.block_size
        table = ex.scheduler.block_tables[win.req.req_id].blocks
        pos = range(win.start, win.start + win.length)
        bids = np.asarray([table[p // bs] for p in pos], np.int32)
        offs = np.asarray([p % bs for p in pos], np.int32)
        return self.capture(ex.cache, ex.paged_axes, bids, offs)["rows"], \
            (bids, offs)

    def _wrap(self, ex, compute):
        def run(ctx, step_no):
            wins = ([] if self.checked is not None else
                    [(w, w.req.num_tokens) + self._rows(ex, w)
                     for w in ex._plan.spec])
            out = compute(ctx, step_no)
            for win, n0, pre, where in wins:
                emitted = win.req.num_tokens - n0
                if self.checked is not None or emitted >= win.length:
                    continue
                post = self.capture(ex.cache, ex.paged_axes, *where)["rows"]
                row0 = False
                for a, b in zip(pre, post):
                    if a is None:
                        continue
                    if not self.torch.equal(a[:, emitted:], b[:, emitted:]):
                        raise AssertionError(
                            f"spec: rejected rows {emitted}..{win.length - 1}"
                            f" of a window changed")
                    row0 |= not self.torch.equal(a[:, 0], b[:, 0])
                if not row0:
                    raise AssertionError("spec: a window's row 0 write "
                                         "did not land")
                self.checked = (win.length, emitted)
            return out
        return run


def spec_summary(eng):
    st = eng.prefill_stats()
    return (f"windows {st['spec_windows']}, drafts {st['spec_drafts']}, "
            f"accepted {st['spec_accepted']}, emitted {st['spec_emitted']} "
            f"(acceptance {st['spec_accepted'] / max(st['spec_drafts'], 1):.4f}"
            f"), histogram {json.dumps(eng.spec_histogram())}")


def shared_tokens(got, want):
    """Tokens equal position by position, of those ``want`` holds."""
    return (sum(a == b for m, c in zip(got, want) for a, b in zip(m, c)),
            sum(len(c) for c in want))


def serve_spec(torch, cfg, path, workdir, seed, profile, kept):
    """The speculation paths: the 8 pattern prompts (``_spec_prompts``)
    with windows of up to 6 rows, without a fault (the first partially
    rejected window checked by ``SpecWatch``), and on ``spec`` also with
    the step-6 fault, revived as every path.  Prints the windows, drafts,
    accepted and emitted tokens and the histogram, and the tokens shared
    with the plain composed engine on the same prompts (bf16 and another
    row count a launch can part the streams: not checked)."""
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    new_tokens = 32
    prompts = _spec_prompts(cfg.vocab_size, seed)

    def run(p, fault=False, watch=False):
        eng = make_engine(torch, cfg, p, workdir, seed,
                          RecoveryPolicy(allow_role_switch=False))
        w = SpecWatch(torch, eng) if watch else None
        if fault:
            schedule_fault(eng, cfg)
        launches.clear()
        reqs, rates = _serve(torch, eng, cfg.vocab_size, seed, new_tokens,
                             prompts=prompts)
        counts = dict(launches)
        return eng, reqs, rates, counts, w

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    if ("spec", "plain") not in kept:
        eng, reqs, _, _, _ = run("composed")
        kept["spec", "plain"] = [list(r.output_tokens) for r in reqs]
        del eng, reqs
        gc.collect()
    eng, reqs, clean, counts, watch = run(path, watch=True)
    if any(r.state.value != "finished" for r in reqs) or eng.reports:
        raise AssertionError(f"engine {path} (no fault): not every request "
                             f"finished")
    st = eng.prefill_stats()
    if st["spec_windows"] <= 0 or watch.checked is None:
        raise AssertionError(f"engine {path}: windows {st['spec_windows']}, "
                             f"no partially rejected window checked")
    streams = [list(r.output_tokens) for r in reqs]
    same, total = shared_tokens(streams, kept["spec", "plain"])
    log(f"  no fault: {json.dumps({k: round(v, 3) for k, v in clean.items()})}"
        f"; {spec_summary(eng)}; a window of {watch.checked[0]} rows emitted "
        f"{watch.checked[1]}: its rejected rows hold their pre-step bits, "
        f"its row 0 write stands; {same} of {total} tokens equal the plain "
        f"composed run's on these prompts, position by position (bf16; not "
        f"checked)")
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    fault = clean
    if path == "spec":
        eng, reqs, fault, counts, _ = run(path, fault=True)
        log("  with fault: " + json.dumps(
            {k: round(v, 3) for k, v in fault.items()}) + "; "
            + spec_summary(eng))
        check_revived(eng, cfg, path, reqs, counts)
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine {path}: kernel launches {counts}")
    return {k: counts[k] for k in used}, (clean, fault), streams


def drop_free(cfg):
    """``cfg`` with its MoE capacity factor raised to physical experts /
    top-k, so that an expert's capacity equals the step's token count:
    a token's top-k go to distinct physical slots, so no slot is offered
    more rows than the step has, and no row drops."""
    import dataclasses
    m = cfg.moe
    cf = (m.num_experts + m.num_redundant_experts) / m.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf))


def serve_overlap(torch, cfg, path, workdir, seed, profile, kept):
    """The overlap path against lockstep twins of the same options: the 8
    prompts without a fault and with the step-6 fault (the twins' streams
    are the composed path's, when it ran), then ``spec_window=6`` on the
    8 pattern prompts (``_spec_prompts``): in bf16 at temperature 0.8,
    and in f32 greedy.  Each run's streams equal its twin's bitwise.

    An overlap step plans the next step's windows from the tokens it
    guessed for the step in flight, so a row can run in another launch
    than in lockstep (a window's chunk launch, not the decode launch).
    The speculation runs therefore serve with a drop-free MoE capacity
    (``drop_free``): over capacity, which rows drop depends on the launch
    (ROADMAP Queue 3).  And a row's logits depend on its launch in their
    last bits, which parts a bf16 stream, and a sampled one in f32 too
    (``scripts/overlap_spec_probe.py``).  In bf16 at 0.8 the epilogue's
    tie order replans nearly every drain (ROADMAP 1l), which rolls the
    windows planned from guesses back; lockstep plans none on these
    prompts (a sample breaks the pattern), so neither commits one.  The
    f32 greedy run commits windows planned from guesses, mispredicts
    their accept counts, reconciles, unwinds their frames newest first
    and restores their rejected rows: it asserts windows and replans.
    Every run is timed without the per-step synchronize, the twins too."""
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    from repro_torch.serving.sampling import SamplingParams
    new_tokens = 32
    hot = dict(spec_window=6,
               sampling=SamplingParams(temperature=0.8, top_p=0.9,
                                       seed=seed))

    def run(overlap, fault=False, prompts=None, model=cfg, dtype=None,
            **over):
        eng = make_engine(torch, model, path, workdir, seed,
                          RecoveryPolicy(allow_role_switch=False),
                          dtype=dtype, overlap=overlap, **over)
        if fault:
            schedule_fault(eng, cfg)
        launches.clear()
        reqs, rates = _serve(torch, eng, cfg.vocab_size, seed, new_tokens,
                             prompts=prompts, sync=False)
        counts = dict(launches)
        if any(r.state.value != "finished" for r in reqs):
            raise AssertionError(f"engine {path}: requests "
                                 f"{[r.state.value for r in reqs]}")
        streams = [list(r.output_tokens) for r in reqs]
        return eng, streams, rates, counts

    def same(what, got, want):
        if got != want:
            a, b = shared_tokens(got, want)
            raise AssertionError(f"engine {path} ({what}): overlap streams "
                                 f"differ from lockstep ({a} of {b} equal)")

    def rounded(rates):
        return json.dumps({k: round(v, 3) for k, v in rates.items()})

    def stats(eng, rates):
        st = eng.overlap_stats()
        if st["planned_ahead"] <= 0:
            raise AssertionError(f"engine {path}: overlap_stats {st}")
        return (rounded(rates) + f"; overlap_stats {json.dumps(st)}, "
                f"host_gap_fraction {eng.host_gap_fraction():.4f}")

    def versus(what, ovl, lock):
        log(f"  {what}: overlap decode tokens/s {ovl['decode_tok_s']:.3f} "
            f"against the lockstep twin's {lock['decode_tok_s']:.3f}; "
            f"end-to-end {ovl['e2e_tok_s']:.3f} against "
            f"{lock['e2e_tok_s']:.3f} (both timed without the per-step "
            f"synchronize)")

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    eng, lock, lock_rates, _ = run(False)
    log(f"  lockstep twin, no fault: {rounded(lock_rates)}; "
        f"host_gap_fraction {eng.host_gap_fraction():.4f}")
    if ("composed", "fault") in kept:
        want_fault = kept["composed", "fault"]
    else:
        del eng
        gc.collect()
        eng, want_fault, _, _ = run(False, fault=True)
    del eng
    gc.collect()
    eng, streams, clean, _ = run(True)
    same("no fault", streams, lock)
    log("  overlap, no fault: " + stats(eng, clean))
    del eng
    gc.collect()
    eng, got, fault, counts = run(True, fault=True)
    same("fault", got, want_fault)
    reqs = [r for r in eng.all_requests]
    log("  overlap, with fault: " + stats(eng, fault))
    used = check_revived(eng, cfg, path, reqs, counts)
    del eng, reqs
    gc.collect()
    free = drop_free(cfg)
    log(f"  spec_window 6 on the pattern prompts, every engine with MoE "
        f"capacity_factor {free.moe.capacity_factor} (physical experts / "
        f"top-k: an expert's capacity is the step's token count, no row "
        f"drops; {cfg.moe.capacity_factor} elsewhere)")
    spec_prompts = _spec_prompts(cfg.vocab_size, seed)
    spec_rates = {}
    for what, dtype, over in (
            ("bf16 at temperature 0.8", None, hot),
            ("f32 greedy", torch.float32, dict(spec_window=6))):
        eng, want, lock_spec, _ = run(False, prompts=spec_prompts,
                                      model=free, dtype=dtype, **over)
        log(f"  lockstep twin, spec_window 6, {what}: {rounded(lock_spec)}"
            f"; {spec_summary(eng)}")
        del eng
        gc.collect()
        eng, got, ovl_spec, _ = run(True, prompts=spec_prompts, model=free,
                                    dtype=dtype, **over)
        same(f"spec, {what}", got, want)
        st = eng.overlap_stats()
        pst = eng.prefill_stats()
        if st["replans"] <= 0 or (dtype is not None and not
                                  0 < pst["spec_accepted"]
                                  < pst["spec_drafts"]):
            raise AssertionError(f"engine {path} (spec, {what}): "
                                 f"{spec_summary(eng)}; overlap_stats {st}")
        log(f"  overlap, spec_window 6, {what}: " + stats(eng, ovl_spec)
            + "; " + spec_summary(eng))
        spec_rates[what] = (ovl_spec, lock_spec)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    versus("no fault", clean, lock_rates)
    for what, (ovl_spec, lock_spec) in spec_rates.items():
        versus(f"spec_window 6, {what}", ovl_spec, lock_spec)
    return {k: counts[k] for k in used}, (clean, fault), streams


def serve_http_path(torch, cfg, path, workdir, seed, profile, kept):
    """The launcher behind its HTTP front end, in a child process: ``python
    -m repro_torch.launch.serve --fleet 2 --mode collocated --overlap
    --http 0 --config full --layers N --device cuda --workdir <the qwen
    group's workdir>`` (both instances load the group's weights.npz),
    drilled by ``scripts/http_smoke_torch.py``: 48 tokens streamed over
    SSE, a device fault through ``/control`` after 6 of them, revived in
    place; ``/instances`` shows the revive decision with its cost table;
    ``/health`` degraded, then healthy after ``planned_restart``.  The
    arbiter is not forced.  A failed drill fails the run; the child is
    stopped in the drill's ``finally``.  Its kernel launches (another
    process) are not counted.  Returns ({}, None, None)."""
    import importlib.util
    from repro_torch.core.weights import RecoveryPolicy
    if profile:
        log("  http: not traced (the engines run in the child process)")
    if not (workdir / "weights.npz").exists():
        log("  http: the group's weights.npz is written first, by one "
            "composed engine")
        eng = make_engine(torch, cfg, "composed", workdir, seed,
                          RecoveryPolicy(allow_role_switch=False))
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "http_smoke_torch", ROOT / "scripts" / "http_smoke_torch.py")
    drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drill)
    args = drill.parse_args(["--device", "cuda", "--config", "full",
                             "--layers", str(cfg.num_layers),
                             "--workdir", str(workdir)])
    log(f"engine: path {path!r}: " + json.dumps(PATHS[path])
        + "; launcher: " + " ".join(drill.launcher_cmd(args)[1:]))
    weights = workdir / "weights.npz"
    stamp = weights.stat().st_mtime_ns
    numbers = drill.run(args)
    if weights.stat().st_mtime_ns != stamp:
        raise AssertionError("engine http: the launcher wrote weights.npz")
    log(f"  http drill passed: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in numbers.items()}))
    log(f"  http client: boot {numbers['boot_s']:.3f} s, TTFT "
        f"{numbers['ttft_s']:.4f} s over HTTP, largest SSE gap "
        f"{numbers['max_sse_gap_s']:.4f} s across the revive, revive "
        f"{numbers['revive_s']:.4f} s (Table-1 total), planned restart to "
        f"healthy {numbers['restart_to_healthy_s']:.3f} s")
    return {}, None, None


@contextlib.contextmanager
def plain_attention():
    """``ops.paged_attention`` and ``ops.flash_prefill`` rebound to their
    plain versions, for the ring paths' checks on the card (the kernels'
    wrappers, and so their counts, are not called)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.kernels.paged_attention import paged_attention_plain
    saved = ops.paged_attention, ops.flash_prefill
    ops.paged_attention, ops.flash_prefill = (paged_attention_plain,
                                              flash_prefill_plain)
    try:
        yield
    finally:
        ops.paged_attention, ops.flash_prefill = saved


def serve_ring(torch, cfg, path, workdir, seed, profile, kept):
    """The ``vlm`` or ``audio`` path: the ring serve step of ``cfg`` in
    bf16 on the card, weights from ``Model.init(seed)`` there (no engine,
    no weights.npz): one ``prefill`` of RING_PATHS[path]'s rows (seeded
    patches or frames, 16-64 or 8-16 text tokens) into rings of its
    ``max_seq``, then RING_NEW_TOKENS greedy ``decode_step``s, timed
    (the audio's encoder and cross K/V also alone, before), its launches
    counted from 0 just before the prefill.  Then the same prefill and
    steps, fed the same tokens, through the plain attention versions on
    the card: each step's logits within RING_LOGIT_RTOL.  Returns
    (launch counts, None, None)."""
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    spec, n_new = RING_PATHS[path], RING_NEW_TOKENS
    t0 = time.perf_counter()
    m = Model(cfg, torch.bfloat16, device="cuda")
    params = m.init(seed)
    torch.cuda.synchronize()
    log(f"engine: path {path!r}: the ring serve step (Model.prefill, "
        f"decode_step; no engine); bf16 weights from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(seed + 11)
    B, (lo, hi) = spec["rows"], spec["text"]
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in ring_inputs(
        cfg, seed + 12, [hi, *rng.integers(lo, hi + 1, B - 1)]).items()}

    def run(fed=None):
        """prefill, then the decode steps, fed ``fed`` or greedy tokens:
        (per-step logits, fed tokens, prefill s, decode s, the cache)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = m.prefill(params, batch, max_seq=spec["max_seq"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, tokens = [last], []
        for i in range(n_new):
            tokens.append(logits[-1][:, :cfg.vocab_size].argmax(-1)
                          if fed is None else fed[i])
            last, cache = m.decode_step(params, cache, tokens[-1])
            logits.append(last)
        torch.cuda.synchronize()
        return logits, tokens, t1 - t0, time.perf_counter() - t1, cache

    run()                                           # warm-up
    stages = {}
    if cfg.family == "audio":   # the prefill's first two stages alone
        frames = batch["frames"].to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = m._encode(params, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m._cross_kv(params, enc)
        torch.cuda.synchronize()
        stages = {"encoder": t1 - t0, "cross K/V": time.perf_counter() - t1}
        del enc, frames
    launches.clear()
    logits, fed, prefill_s, decode_s, cache = run()
    counts = {k: v for k, v in launches.items() if v}
    want_pos = (batch["lengths"] + n_new).tolist()
    if cache["pos"].tolist() != want_pos:
        raise AssertionError(f"engine {path}: positions "
                             f"{cache['pos'].tolist()}, expected {want_pos}")
    del cache
    with plain_attention():
        plain = run(fed)[0]
    errs, agree = [], 0
    for i, (got, want) in enumerate(zip(logits, plain)):
        g, w = got.float(), want.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"engine {path}: step {i} logits not "
                                 f"finite")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        errs.append(err)
        if not bool(((g - w).abs()
                     <= RING_LOGIT_RTOL * (scale + w.abs())).all()):
            raise AssertionError(f"engine {path}: step {i} logits vs the "
                                 f"plain attention: max_abs_err {err} "
                                 f"(logit scale {scale})")
        agree += int((g[:, :cfg.vocab_size].argmax(-1)
                      == w[:, :cfg.vocab_size].argmax(-1)).sum())
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine {path}: kernel launches {counts}")
    rate = B * n_new / decode_s
    log(f"  {B} rows of {batch['lengths'].tolist()} positions"
        + (f" ({cfg.num_patches} patches each)" if cfg.family == "vlm"
           else f" over {cfg.encoder_seq} frames each")
        + f", rings of {spec['max_seq']} slots: "
        + "".join(f"{k} {v:.4f} s, " for k, v in stages.items())
        + f"prefill {prefill_s:.4f} s, {n_new} decode steps {decode_s:.4f} "
        f"s ({rate:.1f} tok/s); launches {counts}; logits vs the plain "
        f"attention on the card, same fed tokens: max_abs_err "
        f"{max(errs):.3e} (rtol {RING_LOGIT_RTOL:g} of the step's scale), "
        f"greedy argmax equal in {agree} of {B * (n_new + 1)}")
    del logits, plain, params, m
    _free(torch)
    return {k: counts[k] for k in used}, None, None


@contextlib.contextmanager
def plain_training_kernels():
    """The launchers that ``FlashPrefill``, ``ExpertFFN`` and ``SSMScan``
    take for CUDA tensors (forward and backward) rebound to the plain
    versions and the written-out plain backward: the train paths'
    reference on the card (the kernels' wrappers, and so their counts,
    are not called)."""
    from repro_torch.kernels import expert_ffn, flash_prefill, ssm_scan
    swaps = [(flash_prefill, "flash_prefill_cuda", "flash_prefill_plain"),
             (flash_prefill, "flash_prefill_bwd_cuda",
              "flash_prefill_bwd_plain"),
             (expert_ffn, "expert_ffn_cuda", "expert_ffn_plain"),
             (expert_ffn, "expert_ffn_bwd_cuda", "expert_ffn_bwd_plain"),
             (ssm_scan, "ssm_scan_cuda", "ssm_scan_plain"),
             (ssm_scan, "ssm_scan_bwd_cuda", "ssm_scan_bwd_plain")]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, getattr(mod, plain))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# the train path's steps, each of TRAIN_BATCH rows of TRAIN_SEQ tokens
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 256
# kernel and plain trainers: every logged number (relative), and step
# 0's gradient of every leaf (of the leaf's largest |gradient|)
TRAIN_RTOL = 1e-3


def train_grads(torch, m, params, batch):
    """The gradient of ``m.loss`` at ``params`` on ``batch`` (a train
    step's, before its update), as (key, tensor) pairs in leaf order."""
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import as_leaves
    leaves = as_leaves(params)
    batch = {k: torch.as_tensor(v).to(m.device) for k, v in batch.items()}
    with torch.enable_grad():
        loss, _ = m.loss(leaves, batch)
    keys, ts = zip(*flatten(leaves))
    grads = torch.autograd.grad(loss, ts, allow_unused=True)
    return [(k, torch.zeros_like(t) if g is None else g)
            for k, t, g in zip(keys, ts, grads)]


def train_against_plain(torch, cfg, seed, what, keep=None):
    """``train_loop.train`` of ``cfg`` in f32 on the card from
    ``Model.init(seed)``, batches ``make_batch(DataConfig(vocab,
    TRAIN_SEQ, TRAIN_BATCH), step)``, AdamW at lr 3e-4 after one warmup
    step (updates of a real run's size, so steps 1 and 2 follow the
    gradients), its launches counted from 0 just before; then the same
    steps from the same params through the plain versions and the
    written-out plain backward on the card (``plain_training_kernels``):
    every step's loss, ce, aux and grad_norm within TRAIN_RTOL, and step
    0's gradient of every leaf (``train_grads``) within TRAIN_RTOL of the
    leaf's largest |gradient|.  Returns the kernel run's launch counts;
    with ``keep`` (a dict) leaves the config, the initial params (on the
    card), the batches and the kernel run's peak memory there under
    ``"qwen_f32"`` for the tp path."""
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import train
    t0 = time.perf_counter()
    m = Model(cfg, torch.float32, device="cuda")
    params = m.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten(params))
    log(f"  {what}: train_loop.train, no engine; {n_params / 1e9:.3f} B f32 "
        f"parameters from seed {seed} in {time.perf_counter() - t0:.1f} s; "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    dc = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [make_batch(dc, step) for step in range(TRAIN_STEPS)]

    opt = OptimizerConfig(warmup_steps=1, total_steps=TRAIN_STEPS)

    def run():
        return train(m, iter(batches), TRAIN_STEPS, opt, log_every=1,
                     params=params)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    got, hist = run()
    counts = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    # the kernel trainer's params wait on the host while the plain one runs
    got = {k: t.detach().cpu() for k, t in flatten(got)}
    step_s = np.diff([0.0] + [h["elapsed_s"] for h in hist])
    # step 0's gradients, leaf by leaf: the kernels' on the host while
    # the plain versions' are taken (these launches are not counted)
    g_kern = [(k, g.cpu()) for k, g in train_grads(torch, m, params,
                                                   batches[0])]
    with plain_training_kernels():
        g_plain = train_grads(torch, m, params, batches[0])
    worst = {}
    for (key, g), (_, w) in zip(g_kern, g_plain):
        scale = float(w.abs().max())
        d = float((g.to(w.device) - w).abs().max())
        worst[key] = d / max(scale, 1e-30)
        if not d <= TRAIN_RTOL * scale:
            raise AssertionError(f"{what}: step 0's gradient of {key} "
                                 f"{d:.3e} from the plain trainer's (scale "
                                 f"{scale:.3e}, rtol {TRAIN_RTOL:g})")
    del g_kern, g_plain
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"  step 0's gradients vs the plain trainer's, {len(worst)} leaves "
        f"within {TRAIN_RTOL:g} of scale; largest: " + ", ".join(
            f"{k} {v:.3e}" for k, v in top))
    with plain_training_kernels():
        want, plain_hist = run()
    rel = 0.0
    for key, w in flatten(want):
        d = float((got[key].to(w.device) - w).abs().max())
        rel = max(rel, d / max(float(w.abs().max()), 1e-30))
    del want, got
    for i, (h, p) in enumerate(zip(hist, plain_hist)):
        log(f"  step {i}: kernels loss {h['loss']:.6f} ce {h['ce']:.6f} aux "
            f"{h['aux']:.6f} grad_norm {h['grad_norm']:.6f} ({step_s[i]:.3f} "
            f"s); plain loss {p['loss']:.6f} ce {p['ce']:.6f} aux "
            f"{p['aux']:.6f} grad_norm {p['grad_norm']:.6f}")
        for key in ("loss", "ce", "aux", "grad_norm"):
            if not (math.isfinite(h[key]) and abs(h[key] - p[key])
                    <= TRAIN_RTOL * abs(p[key])):
                raise AssertionError(f"{what}: step {i} {key} {h[key]} "
                                     f"against plain {p[key]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = float(np.mean(step_s[1:]))
    log(f"  {what}: step seconds {[round(float(s), 4) for s in step_s]} "
        f"(the first builds and warms up), steady {steady:.4f} s = "
        f"{tokens / steady:.1f} training tokens/s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; final params vs the plain trainer's: "
        f"largest relative difference {rel:.3e} (max |d| / max |plain| a "
        f"leaf); launches {counts}")
    if keep is not None:
        keep["qwen_f32"] = (cfg, params, batches, peak)
    del params, m, batches
    _free(torch)
    return counts


def train_launches(m_cfg):
    """The backward kernels' launches that TRAIN_STEPS steps of ``m_cfg``
    make, and the forward kernels' that go with them: a launch a layer
    and step for attention and the scan, and for the expert FFN's
    gradient a launch a MoE layer and step."""
    from repro_torch.models.model import Model
    L = m_cfg.num_layers
    if m_cfg.hybrid_period:
        attn = L // m_cfg.hybrid_period
        ssm = L - attn
    else:
        attn, ssm = (0, L) if m_cfg.family == "ssm" else (L, 0)
    moe = Model(m_cfg, device="cpu")._num_moe_layers()
    want = {"flash_prefill": attn, "flash_prefill_bwd": attn,
            "ssm_scan": ssm, "ssm_scan_bwd": ssm, "expert_ffn_bwd": moe}
    return {k: TRAIN_STEPS * v for k, v in want.items() if v}


def check_train_launches(what, m_cfg, counts):
    want = train_launches(m_cfg)
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def serve_train(torch, cfg, path, workdir, seed, profile, kept):
    """The ``train`` and ``train_ssm`` paths (no engine):
    ``train_against_plain`` of ``cfg`` (qwen2-moe-a2.7b through
    flash_prefill, expert_ffn and their backward kernels; falcon-mamba-7b
    through ssm_scan and ssm_scan_bwd), each kernel launched as
    ``train_launches`` says.  Then the launcher (``python -m
    repro_torch.launch.train``) trains the same model for 3 steps in a
    child process.  ``train_ssm`` then holds the smoke
    jamba-1.5-large-398b period (attention, seven Mamba and four
    gather_psum MoE sublayers: all three backward kernels in one model)
    the same way.  Returns (launch counts of ``cfg``'s kernel run, None,
    None)."""
    log(f"engine: path {path!r}: {cfg.name}, {cfg.num_layers} layers")
    counts = train_against_plain(
        torch, cfg, seed, f"engine {path}",
        keep=kept if path == "train" and kept.get("tp_train") else None)
    check_train_launches(f"engine {path}", cfg, counts)

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           cfg.name, "--layers", str(cfg.num_layers), "--steps", "3",
           "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
           "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(
                              os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = proc.stdout.strip().splitlines()
    log(f"  launcher ({' '.join(cmd[1:])}) exited {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s:")
    for line in lines:
        log(f"    {line}")
    final = lines[-1] if lines else ""
    if (proc.returncode != 0 or not final.startswith("final loss:")
            or not math.isfinite(float(final.split(":")[1]))):
        raise AssertionError(f"engine {path}: the launcher failed:\n"
                             f"{proc.stderr[-3000:]}")
    if path == "train_ssm":
        from repro_torch.configs import get_smoke_config
        hybrid = get_smoke_config(PATH_ARCH["hybrid"])
        what = f"engine {path}: {hybrid.name}"
        check_train_launches(what, hybrid, train_against_plain(
            torch, hybrid, seed, what))
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    return {k: counts[k] for k in used}, None, None


# the examples path: each twin with its OK line (train_moe_torch.py's
# last line after its "did not learn" assertion passed)
EXAMPLES = {"quickstart_torch.py": "OK", "degraded_serving_torch.py": "OK",
            "failover_serving_torch.py": "OK",
            "train_moe_torch.py": "checkpoint restores OK"}


def serve_examples(torch, cfg, path, workdir, seed, profile, kept):
    """The ``examples`` path: the four ``examples/*_torch.py`` twins with
    ``--device cuda``, each in a child process of its own (all four at
    once: their smoke models take a few hundred MB of the card), each in
    its own workdir under ``workdir``; each must exit 0 with its OK line.
    Their launches are not counted (other processes).  Returns ({}, None,
    None)."""
    procs = {}
    t0 = time.perf_counter()
    for name in EXAMPLES:
        wd = workdir / name.split(".")[0]
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / name), "--device",
             "cuda", "--workdir", str(wd)], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    failed = []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        ok = proc.returncode == 0 and lines and lines[-1].startswith(
            EXAMPLES[name])
        log(f"  {name}: exit {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s; {len(lines)} lines, the "
            f"last {lines[-1] if lines else ''!r}")
        for line in lines:
            if "loss" in line or "recovery" in line or "finished" in line:
                log(f"    {line}")
        if not ok:
            failed.append(f"{name}:\n{out[-2000:]}\n{err[-3000:]}")
    if failed:
        raise AssertionError("engine examples: " + "\n".join(failed))
    return {}, None, None

# the dist path: each impl of the distributed MoE layer on a world of one
# under NCCL, qwen2-moe-a2.7b at full width in bf16, in the train path's
# group (TRAIN_LAYERS deep): logits_full over DIST_ROWS x DIST_SEQ
# tokens, then the ring prefill of the same rows and DIST_STEPS decode
# steps (T = DIST_ROWS a step)
DIST_IMPLS = ("gather_psum", "gather_psum_fused", "a2a", "a2a_fused")
DIST_ROWS, DIST_SEQ, DIST_STEPS = 4, 256, 16
# the collectives' ops in a torch.profiler trace: the c10d op on the host,
# NCCL's kernels (or copies) on the device
# a2a_fused's end-to-end bound: the share of the forward's token rows
# within TOL["bfloat16"] of the local path (the rest: tokens whose experts
# a rounding flipped in the second layer; 1.74% of the logits of the
# card test's 2 x 64 tokens when it was first run)
DIST_ROWS_WITHIN = 0.9
DIST_OPS = ("nccl", "c10d")


def dist_run(torch, model, params, tokens, fed=None):
    """logits_full, then the ring prefill and DIST_STEPS decode steps,
    greedy or fed ``fed`` (DIST_STEPS, B).  Returns (logits of the
    forward, each step's logits, the tokens fed, forward s, decode s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.logits_full(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tokens},
                                max_seq=tokens.shape[1] + DIST_STEPS)
    steps, toks = [last], []
    V = model.cfg.vocab_size
    for i in range(DIST_STEPS):
        toks.append(last[:, :V].argmax(-1) if fed is None else fed[i])
        last, cache = model.decode_step(params, cache, toks[-1])
        steps.append(last)
    torch.cuda.synchronize()
    return (logits, torch.stack(steps), torch.stack(toks), t1 - t0,
            time.perf_counter() - t1)


def dist_collectives(torch, model, params, tokens):
    """One ring decode step of ``model`` (after a 4-token prefill) under
    torch.profiler: each collective op's host and device time, and the
    step's device busy time and wall time."""
    from torch.profiler import ProfilerActivity, profile
    last, cache = model.prefill(params, {"tokens": tokens[:, :4]},
                                max_seq=8)
    tok = last[:, :model.cfg.vocab_size].argmax(-1)
    model.decode_step(params, cache, tok)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    ops = {e.key: (e.count, e.cpu_time_total / 1e3,
                   e.self_device_time_total / 1e3)
           for e in ev if any(k in e.key.lower() for k in DIST_OPS)}
    return ops, busy, wall * 1e3


def dist_layer_check(torch, local, model, params, block, T, seed):
    """Each MoE layer's ``Model._moe`` (routed + shared experts) through
    ``model``'s distributed layer on its ``block`` of the bank against
    ``local``'s on the whole bank, over the same seeded (T, D) bf16
    input: the largest difference (0.0 when bitwise equal)."""
    from repro_torch.models.layers import take_layer
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, local.cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rt = local.default_runtime()
    worst = 0.0
    for i in range(local.cfg.num_layers):
        w = local._moe(take_layer(params["layers"], i)["moe"], x, rt,
                       local._cap(T))
        g = model._moe(take_layer(block["layers"], i)["moe"], x, rt,
                       model._cap(T))
        compare(f"dist {model.cfg.moe_impl} MoE layer {i}, T={T}", g, w,
                "bfloat16")
        worst = max(worst, float((g.float() - w.float()).abs().max()))
    return worst


def serve_dist(torch, cfg, path, workdir, seed, profile, kept):
    """The ``dist`` path (no engine): a world of one under NCCL
    (``init_process_group("nccl", ...)`` through a FileStore in the
    workdir, ``make_mesh((1, 1), ("data", "model"), "cuda")``), bf16
    weights from ``Model.init(seed)`` on the card; for each impl of
    DIST_IMPLS the model without ``moe_dist`` (``dist_run``, greedy), then
    with ``make_moe_dist(mesh, impl)`` on its ``shard_params`` block (the
    whole bank at a world of one), fed the same tokens, its launches
    counted: each fused run launches ``moe_fused`` once a layer and call,
    each other run ``expert_ffn``.  ``gather_psum_fused`` must be bitwise
    equal to the local fused path in the forward's and every step's
    logits (its collectives are identities and ``cap_for`` gives the
    local capacity); ``gather_psum`` and ``a2a`` within TOL["bfloat16"]
    of the local path.  ``a2a_fused`` rounds otherwise (its received rows
    leave the fused kernel in bf16, one a copy, and are weighted and
    summed outside it), so a near-tie in the second layer's router can
    flip a token's experts: each MoE layer is held within
    TOL["bfloat16"] of the local fused layer on the same inputs at the
    forward's and a decode step's token counts (``dist_layer_check``, for
    every impl), and at least DIST_ROWS_WITHIN of the forward's token rows
    must be within TOL["bfloat16"] end to end.  Then one decode step of
    each under torch.profiler: the collectives' host and device time.
    Returns (launch counts, None, None)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.distributed.collectives import make_moe_dist
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "nccl_store"
    store.unlink(missing_ok=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(store), 1),
                            device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        probe = torch.ones(8, device=dev)
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(probe, group=mesh.get_group(axis))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if any(dist.get_backend(mesh.get_group(a)) != "nccl"
               for a in mesh.mesh_dim_names):
            raise AssertionError("engine dist: the mesh's groups are not "
                                 "NCCL's")
        t0 = time.perf_counter()
        params = Model(cfg, torch.bfloat16, device=dev).init(seed)
        torch.cuda.synchronize()
        log(f"engine: path {path!r}: the distributed MoE layer on a world "
            f"of one, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} "
            f"(init_process_group, make_mesh and a first all_reduce on each "
            f"axis {init_s:.3f} s); bf16 weights from seed {seed} in "
            f"{time.perf_counter() - t0:.1f} s; {DIST_ROWS} x {DIST_SEQ} "
            f"tokens, then {DIST_STEPS} decode steps")
        tokens = torch.from_numpy(np.random.default_rng(seed + 21).integers(
            0, cfg.vocab_size, (DIST_ROWS, DIST_SEQ))).to(dev)
        # the first forward builds cuBLAS's handles and the allocator's
        # pools: not any impl's time
        dist_run(torch, Model(cfg, torch.bfloat16, device=dev), params,
                 tokens)
        counts = {}
        calls = cfg.num_layers * (2 + DIST_STEPS)
        atol, rtol = TOL["bfloat16"]
        for impl in DIST_IMPLS:
            c = dataclasses.replace(cfg, moe_impl=impl)
            local = Model(c, torch.bfloat16, device=dev)
            want = dist_run(torch, local, params, tokens)
            md = make_moe_dist(mesh, impl)
            md.place(DIST_ROWS)
            model = Model(c, torch.bfloat16, device=dev, moe_dist=md)
            block = md.shard_params(params)
            before = dict(launches)
            got = dist_run(torch, model, block, tokens, fed=want[2])
            grew = {k: v - before.get(k, 0) for k, v in launches.items()
                    if v != before.get(k, 0)}
            for k, v in grew.items():
                counts[k] = counts.get(k, 0) + v
            expert = "moe_fused" if c.moe_fused else "expert_ffn"
            if grew.get(expert) != calls:
                raise AssertionError(f"engine dist {impl}: launches {grew}, "
                                     f"expected {calls} of {expert}")
            layer_err = max(dist_layer_check(torch, local, model, params,
                                             block, T, seed + 22)
                            for T in (DIST_ROWS * DIST_SEQ, DIST_ROWS))
            errs, bitwise, within = [], [], 1.0
            for what, g, w in (("forward", got[0], want[0]),
                               ("decode", got[1], want[1])):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"engine dist {impl}: {what} "
                                         f"logits not finite")
                d = (g.float() - w.float()).abs()
                errs.append(float(d.max()))
                bitwise.append(bool(torch.equal(g, w)))
                ok = (d <= atol + rtol * w.float().abs()).all(dim=-1)
                if what == "forward":
                    within = float(ok.float().mean())
                if impl == "gather_psum_fused" and not bitwise[-1]:
                    raise AssertionError(
                        f"engine dist {impl}: {what} logits differ from "
                        f"the local fused path by {errs[-1]:.3e}")
                if impl != "a2a_fused" and not bool(ok.all()):
                    raise AssertionError(
                        f"engine dist {impl}: {what} logits vs the local "
                        f"path: max_abs_err {errs[-1]:.3e} (atol {atol:g}, "
                        f"rtol {rtol:g})")
            if within < DIST_ROWS_WITHIN:
                raise AssertionError(
                    f"engine dist {impl}: {within:.4f} of the forward's "
                    f"token rows within tolerance of the local path")
            V = cfg.vocab_size
            agree = int((got[1][:DIST_STEPS, :, :V].argmax(-1)
                         == want[2]).sum())
            log(f"  {impl}: forward {got[3]:.4f} s (local {want[3]:.4f} s), "
                f"prefill + {DIST_STEPS} decode steps {got[4]:.4f} s (local "
                f"{want[4]:.4f} s); vs local: forward max_abs_err "
                f"{errs[0]:.3e}{' (bitwise)' if bitwise[0] else ''}, "
                f"{within:.4f} of its token rows within tolerance; decode "
                f"max_abs_err {errs[1]:.3e}"
                f"{' (bitwise)' if bitwise[1] else ''}; greedy tokens equal "
                f"{agree} of {DIST_STEPS * DIST_ROWS}; MoE layers alone "
                f"max_abs_err {layer_err:.3e}; launches {grew}")
            ops, busy, wall = dist_collectives(torch, model, block, tokens)
            log(f"    one decode step under torch.profiler: {wall:.3f} ms "
                f"wall, device busy {busy:.3f} ms; collectives (calls, host "
                f"ms, device ms): " + (", ".join(
                    f"{k} {n}x {h:.3f} {d:.3f}" for k, (n, h, d) in
                    sorted(ops.items())) or "none seen"))
            del want, got, model, local, block
            _free(torch)
        # the dryrun and tp paths' model when they come next (the same
        # weights), and the tp path's process group
        kept["qwen_bf16"] = (cfg, params)
        kept["nccl"] = mesh
        del params
        _free(torch)
    finally:
        if "nccl" not in kept:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine dist: launches {counts}")
    return {k: counts[k] for k in used}, None, None

DRYRUN_ARCH, DRYRUN_SHAPE = "qwen2-moe-a2.7b", "decode_32k"
DRYRUN_ROWS, DRYRUN_SEQ = 4, 2048
# the keys of the JAX package's dry-run record (its run_dryrun)
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "kind", "moe_impl",
               "lower_s", "compile_s", "memory", "per_device_flops",
               "per_device_bytes", "cost_extrapolation", "collectives",
               "collectives_4unit", "collective_wire_bytes", "roofline",
               "model_flops", "hlo_flops_total", "useful_flops_ratio",
               "params", "elapsed_s")


# the kernels of the dryrun path and the tolerance each is held to
# against its plain version on the same inputs
DRYRUN_HELD = {"flash_prefill": FLASH_TOL, "expert_ffn": FFN_TOL,
               "paged_attention": TOL}


def held_on_card(name, got, want, dn, tol):
    """``compare`` computed on the card (the path's tensors are large):
    |got - want| <= atol + rtol * |want| everywhere, got finite; the
    largest difference."""
    atol, rtol = tol[dn]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    err = float(d.max()) if d.numel() else 0.0
    bad = int((d > atol + rtol * w.abs()).sum())
    ok = bad == 0 and bool(g.isfinite().all())
    log(f"  {name:<44} max_abs_err {err:.3e}  (atol {atol:g}, rtol {rtol:g})"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {bad} elements outside tolerance "
                             f"or not finite, max_abs_err {err}")
    return err


@contextlib.contextmanager
def held_to_plain(errs):
    """The wrappers of DRYRUN_HELD's kernels in ``ops`` wrapped: each call
    launches the kernel, then runs its plain version on the same inputs
    on the card, holds the two within the kernel's tolerance
    (``held_on_card``; the largest difference into ``errs[name]``) and
    returns the kernel's output."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.expert_ffn import expert_ffn_plain
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.kernels.paged_attention import paged_attention_plain
    plain = {"flash_prefill": flash_prefill_plain,
             "expert_ffn": expert_ffn_plain,
             "paged_attention": paged_attention_plain}
    saved = {name: getattr(ops, name) for name in DRYRUN_HELD}

    def wrap(name):
        def held(*args, **kw):
            got = saved[name](*args, **kw)
            want = plain[name](*args, **kw)
            err = held_on_card(
                f"dryrun {name} {'x'.join(map(str, args[0].shape))} "
                f"{str(got.dtype).split('.')[-1]}", got, want,
                str(got.dtype).split(".")[-1], DRYRUN_HELD[name])
            errs[name] = max(errs.get(name, 0.0), err)
            return got
        return held
    for name in DRYRUN_HELD:
        setattr(ops, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def plain_serving():
    """``plain_attention``, and ``ops.expert_ffn`` rebound to its plain
    version: the dryrun path's reference on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.expert_ffn import expert_ffn_plain
    saved = ops.expert_ffn
    ops.expert_ffn = expert_ffn_plain
    try:
        with plain_attention():
            yield
    finally:
        ops.expert_ffn = saved


@contextlib.contextmanager
def routing(log, replay=False):
    """``models.moe.route`` wrapped: each call's (weights, choices)
    appended to ``log``, or with ``replay`` the logged ones returned in
    order in place of the call's own, so that a second run routes every
    token as the first did.  Yields [choices of the call's own that
    differ from the logged (rows), rows]."""
    from repro_torch.models import moe
    saved, calls, flips = moe.route, iter(list(log)), [0, 0]

    def wrapped(*args, **kw):
        out = saved(*args, **kw)
        if not replay:
            log.append(out[:2])
            return out
        weights, sel = next(calls)
        flips[0] += int((out[1].sort(-1).values != sel.sort(-1).values)
                        .any(-1).sum())
        flips[1] += sel.shape[0]
        return (weights, sel) + tuple(out[2:])
    moe.route = wrapped
    try:
        yield flips
    finally:
        moe.route = saved


def dryrun_logits(torch, card, params, batch, runtime, step_on=None):
    """The ring prefill of ``batch``, and one decode step fed its greedy
    tokens over ``step_on`` = (a cache, tokens) or else over its own
    cache: (prefill logits, step logits, (a copy of the prefill's cache,
    its greedy tokens))."""
    last, cache = card.prefill(params, batch, runtime)
    tok = last[:, :card.cfg.vocab_size].argmax(-1).to(torch.int32)
    held = (_map(cache, torch.clone), tok)
    step, _ = card.decode_step(params, *(step_on or (cache, tok)), runtime)
    return last, step, held


def placed_bytes(torch, arch, shape_name, multi_pod):
    """Rank 0's argument bytes of the dry run's step, reckoned from the
    port's ShardingRules placements on the production layout (no process
    group): each leaf's bytes over the product of its spec's axes."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import axis_sizes, make_production_mesh
    from repro_torch.launch.specs import step_arg_specs
    from repro_torch.models.model import Model
    layout = make_production_mesh(multi_pod=multi_pod)
    cfg, shape = get_config(arch, shape_name), INPUT_SHAPES[shape_name]
    args = step_arg_specs(Model(cfg, torch.bfloat16, device="cpu"), cfg,
                          shape)
    placed = dryrun.arg_placements(ShardingRules(layout, cfg), shape.kind,
                                   args, shape.global_batch)
    sizes = axis_sizes(layout)

    def one(path, leaf, spec):
        n = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= sizes[a]
        return leaf.numel() * leaf.element_size() // n
    return sum(b for _, b in dryrun._flat(dryrun._map2(one, args, placed)))


def held_bytes(tree):
    """The bytes the storages of a tree's tensors hold (each once)."""
    from repro_torch.launch import dryrun
    seen = {}
    for _, t in dryrun._flat(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def dryrun_card_step(torch, step, args):
    """One step on the card after a warm-up call: (outputs, seconds, the
    peak of memory allocated during it above what was allocated
    before)."""
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = step(*args)
    end.record()
    torch.cuda.synchronize()
    return (out, start.elapsed_time(end) / 1e3,
            torch.cuda.max_memory_allocated() - before)


def serve_dryrun(torch, cfg, path, workdir, seed, profile, kept):
    """The ``dryrun`` path (no engine).  (a) Two child processes run the
    port's dry run of DRYRUN_ARCH at DRYRUN_SHAPE (``python -m
    repro_torch.launch.dryrun``, on the 16 x 16 mesh with its 2- and
    4-unit traces, and on 2 x 16 x 16 with ``--no-extrapolate``): each
    record has the JAX package's keys and its ``argument_bytes`` equals
    the bytes reckoned from ShardingRules' placements (placed_bytes).
    (b) The trace held to the card: qwen2-moe-a2.7b at full width,
    ``cfg``'s 2 layers, bf16, one rank (no process group; the dist
    path's weights when it ran first): the ring prefill of DRYRUN_ROWS x
    DRYRUN_SEQ tokens and one decode step over its cache, each traced by
    ``launch.dryrun.trace`` on fake copies of its arguments and run on
    the card (flash_prefill, expert_ffn and paged_attention over the
    ring).  The trace's ``argument_bytes`` must equal the bytes the
    card's arguments hold; it prints the trace's ``temp_bytes`` beside
    the card's peak above the arguments, and the trace's FLOPs and bytes
    over the card step's time as achieved rates against the data sheet.
    Then the kernels held at these shapes: the same prefill and decode
    step again (not counted), each call of the three kernels held to its
    plain version on the same inputs (``held_to_plain``, DRYRUN_HELD's
    tolerances), and the prefill's and the step's logits held within
    RING_LOGIT_RTOL of the plain versions' on the card
    (``plain_serving``), the plain step run over a copy of the kernels'
    prefill cache and fed the same tokens, and every token routed to
    the experts the kernels' run chose (``routing``): a bf16 near-tie in
    the router flips a token's experts on a rounding, as it did for one
    of the 4 decode rows on the H100 (0.66 of a logit scale of 4.25; the
    other rows within 0.049) before the routing was replayed.  The plain run's own
    choices that differ are counted.  Greedy tokens are counted, not
    required: a bf16 near-tie among the vocabulary's logits can flip
    one, as on the vlm path.  Returns (launch counts, None, None)."""
    from repro_torch.hardware import card_sheet
    from repro_torch.kernels import launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import make_step
    from repro_torch.models.model import Model
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = {}
    for multi_pod in (False, True):
        out = workdir / f"dryrun_{'2x16x16' if multi_pod else '16x16'}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--out", str(out)]
        if multi_pod:
            cmd += ["--multi-pod", "--no-extrapolate"]
        children[multi_pod] = (out, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), time.perf_counter())
    try:
        sheet = card_sheet()
        dev = torch.device("cuda", 0)
        held = kept.get("qwen_bf16")
        t0 = time.perf_counter()
        params = (held[1] if held is not None and held[0] == cfg else
                  Model(cfg, torch.bfloat16, device=dev).init(seed))
        torch.cuda.synchronize()
        log(f"engine: path {path!r}: {cfg.name} at full width, "
            f"{cfg.num_layers} layers, bf16, one rank; weights "
            + ("of the dist path" if held is not None else
               f"from seed {seed} in {time.perf_counter() - t0:.1f} s")
            + f"; {dryrun.card_line(sheet)}")
        card = Model(cfg, torch.bfloat16, device=dev)
        host = Model(cfg, torch.bfloat16, device="cpu")   # holds no weights
        tokens = torch.from_numpy(np.random.default_rng(seed + 31).integers(
            0, cfg.vocab_size, (DRYRUN_ROWS, DRYRUN_SEQ)).astype(
                np.int32)).to(dev)
        runtime = card.default_runtime()
        counts = {}
        steps = (("prefill", (params, {"tokens": tokens}, runtime)),
                 ("decode", None))
        for kind, args in steps:
            if kind == "decode":
                args = (params, cache, nxt, runtime)
            rec = dryrun.trace(make_step(host, kind), args, sheet=sheet)
            want = held_bytes(args)
            if rec["argument_bytes"] != want:
                raise AssertionError(
                    f"engine dryrun {kind}: the trace's argument_bytes "
                    f"{rec['argument_bytes']}, the card's arguments hold "
                    f"{want}")
            before = dict(launches)
            (nxt, cache), secs, peak = dryrun_card_step(
                torch, make_step(card, kind), args)
            for k, v in launches.items():
                if v != before.get(k, 0):
                    counts[k] = counts.get(k, 0) + (v - before.get(k, 0))
            if not (bool((nxt >= 0).all()) and bool(
                    (nxt < cfg.vocab_size).all())):
                raise AssertionError(f"engine dryrun {kind}: next tokens "
                                     f"out of the vocabulary")
            flops, nbytes = rec["flops"], rec["bytes"]
            log(f"  {kind}: trace {rec['seconds']:.2f} s ({rec['ops']} ops; "
                f"argument_bytes {want} = the card's arguments); card step "
                f"{secs * 1e3:.3f} ms; temp_bytes {rec['temp_bytes']} traced"
                f", {peak} above the arguments on the card (trace / card "
                f"{rec['temp_bytes'] / max(peak, 1):.3f}); the trace's "
                f"{flops:.4e} FLOPs and {nbytes:.4e} bytes over the card's "
                f"time: {flops / secs / 1e12:.2f} TFLOP/s "
                f"({flops / secs / sheet['bf16_flops']:.4f} of bf16 peak), "
                f"{nbytes / secs / 1e12:.3f} TB/s "
                f"({nbytes / secs / sheet['hbm_bytes_per_s']:.4f} of HBM; "
                f"the trace's bytes are the plain versions' without fusion)")
        del cache, nxt
        _free(torch)
        batch, held_errs, routed = {"tokens": tokens}, {}, []
        with held_to_plain(held_errs), routing(routed):
            got = dryrun_logits(torch, card, params, batch, runtime)
        missing = [k for k in DRYRUN_HELD if k not in held_errs]
        if missing:
            raise AssertionError(f"engine dryrun: {missing} not held to "
                                 f"their plain versions")
        with plain_serving(), routing(routed, replay=True) as flips:
            want = dryrun_logits(torch, card, params, batch, runtime,
                                 step_on=got[2])
        errs, V = [], cfg.vocab_size
        for what, g, w in (("prefill", got[0], want[0]),
                           ("decode", got[1], want[1])):
            g, w = g.float(), w.float()
            d = (g - w).abs()
            scale = float(w.abs().max())
            errs.append(float(d.max()))
            if not (bool(g.isfinite().all())
                    and bool((d <= RING_LOGIT_RTOL * (scale + w.abs()))
                             .all())):
                raise AssertionError(
                    f"engine dryrun {what}: logits vs the plain versions: "
                    f"max_abs_err {errs[-1]} (logit scale {scale}), by row "
                    f"{d.amax(dim=-1).tolist()}")
        agree = sum(int((g[:, :V].argmax(-1) == w[:, :V].argmax(-1)).sum())
                    for g, w in zip(got[:2], want[:2]))
        log(f"  the kernels at the path's shapes, each call against its "
            f"plain version: max_abs_err " + ", ".join(
                f"{k} {v:.3e}" for k, v in held_errs.items())
            + f"; logits vs the plain versions, the step on the same "
            f"cache and tokens, every token routed as the kernels' run "
            f"routed it (the plain run's own router chose otherwise for "
            f"{flips[0]} of {flips[1]} token rows): prefill "
            f"{errs[0]:.3e}, decode {errs[1]:.3e} (rtol "
            f"{RING_LOGIT_RTOL:g} of the step's scale); greedy argmax "
            f"equal in {agree} of {2 * DRYRUN_ROWS}")
        del params, card, got, want
        _free(torch)
    finally:
        results = {}
        for multi_pod, (out, proc, t0) in children.items():
            stdout, stderr = proc.communicate(timeout=600)
            results[multi_pod] = (out, proc.returncode, stdout, stderr,
                                  time.perf_counter() - t0)
    for multi_pod, (out, rc, stdout, stderr, secs) in results.items():
        if rc != 0 or not out.exists():
            raise AssertionError(f"engine dryrun: the dry run exited {rc}: "
                                 f"{stderr[-2000:]}")
        rec = json.loads(out.read_text())
        missing = [k for k in DRYRUN_KEYS if k not in rec]
        want = placed_bytes(torch, DRYRUN_ARCH, DRYRUN_SHAPE, multi_pod)
        if missing or rec["memory"]["argument_bytes"] != want:
            raise AssertionError(f"engine dryrun {rec.get('mesh')}: missing "
                                 f"{missing}; argument_bytes "
                                 f"{rec['memory']['argument_bytes']}, "
                                 f"placed {want}")
        roof = rec["roofline"]
        log(f"  dry run {DRYRUN_ARCH} x {DRYRUN_SHAPE} x {rec['mesh']}: "
            f"trace {rec['trace_s']:.1f} s ({rec['elapsed_s']:.1f} s in "
            f"run_dryrun, {secs:.1f} s until its process was read; "
            f"{rec['ops']} ops); argument_bytes {want} as placed; roofline "
            f"of the traced tensor-parallel step ({rec['placement'][:40]}"
            f"...) compute {roof['compute_s'] * 1e3:.3f} ms | memory "
            f"{roof['memory_s'] * 1e3:.3f} ms | collective "
            f"{roof['collective_s'] * 1e3:.3f} ms -> {roof['dominant']}; "
            f"useful {rec['useful_flops_ratio']:.4f}; temp "
            f"{rec['memory']['temp_bytes'] / 2**30:.2f} GiB")
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine dryrun: launches {counts}")
    return {k: counts[k] for k in used}, None, None

# the tp path: the tensor-parallel serve steps (``Model(tp=...)``,
# ``distributed/tensor_parallel.py``).  A world of one under NCCL (the
# dist path's group and weights when it ran first): qwen2-moe-a2.7b at
# full width, TRAIN_LAYERS deep, bf16, a ring prefill of TP_ROWS x
# TP_SEQ tokens and TP_STEPS greedy decode steps, bitwise the same model
# without tp; minicpm3-4b at full width, 2 layers, bf16 (MLA: its latent
# ring is split over the window at any 'model' size, so even a world of
# one decodes through paged_attention's lse_out and the merge), bitwise
# likewise.  Then the kernels at the shapes a rank of the production
# mesh's 'model' axis (TP_MODEL) gets, each simulated rank one after the
# other on the one card, each held to its plain version
TP_ROWS, TP_SEQ, TP_STEPS = 4, 2048, 8
TP_MLA_ARCH, TP_MLA_SEQ = "minicpm3-4b", 512
TP_MODEL = 16
TP_RING = 2048
TP_RING_LENS = (2048, 1500, 700, 100)     # the last row: 15 empty slices
TP_LSE_ATOL = 1e-3
# with lse_out the kernel's o is f32: each slice's o, and the merge of the
# 16 slices, held to the plain version run on f32 copies of the inputs
# (the probabilities in f32: the exact result), within TP_MERGE_ATOL by
# the kernel's precision of the probabilities: f32 (every kernel but the
# latent one; 4.2e-07 at most on an H100) or bf16 (the latent kernel
# rounds them before P V; 1.5e-03 at most where |o| reaches 1.45).  A
# merge that drops one rank's slice or weighs the slices alike misses by
# more, which the path checks on its own inputs
TP_MERGE_ATOL = {"f32": 1e-5, "bf16": 4e-3}
# a head-parallel rank's call is an ordinary bf16 one: one rounding of o
# apart from the plain version's
TP_HEAD_TOL = {"bfloat16": (1e-3, 1e-2)}
# the kernels line's "tp" rows, filled by the tp path
TP_RESULTS = {}


def tp_run(torch, model, params, tokens, max_seq, fed=None):
    """The ring prefill, then TP_STEPS decode steps, greedy
    (``specs.greedy``: under tp ``TensorParallel.greedy``) or fed ``fed``.
    Returns (each step's logits, the tokens fed, prefill s, decode s a
    step)."""
    from repro_torch.launch.specs import greedy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tokens}, max_seq=max_seq)
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    steps, toks, secs = [last], [], []
    for i in range(TP_STEPS):
        toks.append(greedy(model, last) if fed is None else fed[i])
        t0 = time.perf_counter()
        last, cache = model.decode_step(params, cache, toks[-1])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        steps.append(last)
    return torch.stack(steps), torch.stack(toks), pre, secs


def tp_world_of_one(torch, cfg, params, mesh, dev, tokens, max_seq, what):
    """``cfg``'s model with ``tp`` (on ``tp_shard`` of ``params``) and
    without, the same ``moe_dist`` in both: every step's logits bitwise
    equal and the greedy tokens equal.  Returns the tp run's launch
    counts."""
    from repro_torch.distributed.collectives import make_moe_dist
    from repro_torch.distributed.sharding import ShardingRules, tp_shard
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.kernels import launches
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    md = None
    if cfg.moe is not None:
        md = make_moe_dist(mesh, cfg.moe_impl)
        md.place(tokens.shape[0])
    rules = ShardingRules(mesh, cfg)
    shards = dryrun._map2(lambda p, t, sp: tp_shard(p, t, sp, mesh), params,
                          rules.params_specs(params))
    model = Model(cfg, torch.bfloat16, device=dev, moe_dist=md,
                  tp=TensorParallel(mesh, rules))
    local = Model(cfg, torch.bfloat16, device=dev, moe_dist=md)
    for m, p in ((local, params), (model, shards)):   # warm: NCCL, cuBLAS
        tp_run(torch, m, p, tokens, max_seq)
    before = dict(launches)
    got = tp_run(torch, model, shards, tokens, max_seq)
    counts = {k: v - before.get(k, 0) for k, v in launches.items()
              if v != before.get(k, 0)}
    want = tp_run(torch, local, params, tokens, max_seq)
    if not bool(torch.isfinite(got[0].float()).all()):
        raise AssertionError(f"engine tp {what}: logits not finite")
    bitwise = bool(torch.equal(got[0], want[0]))
    same_tokens = bool(torch.equal(got[1], want[1]))
    err = float((got[0].float() - want[0].float()).abs().max())
    log(f"  {what}: with tp prefill {got[2]:.4f} s, decode steps "
        + " ".join(f"{s * 1e3:.2f}" for s in got[3]) + " ms; without tp "
        f"prefill {want[2]:.4f} s, decode steps "
        + " ".join(f"{s * 1e3:.2f}" for s in want[3]) + f" ms; logits "
        f"{'bitwise equal' if bitwise else f'differ by {err:.3e}'}, greedy "
        f"tokens {'equal' if same_tokens else 'differ'}; launches {counts}")
    if not (bitwise and same_tokens):
        raise AssertionError(f"engine tp {what}: the tp step is not the "
                             f"local step (max_abs_err {err})")
    del shards, model, local, got, want
    return counts


def tp_held(name, got, want, dtype_name, tol):
    """``got`` within ``tol`` of ``want`` (allclose); returns the error."""
    atol, rtol = tol[dtype_name]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not bool(g.isfinite().all()) or bool(
            (d > atol + rtol * w.abs()).any()):
        raise AssertionError(f"engine tp {name}: max_abs_err "
                             f"{float(d.max())} (atol {atol}, rtol {rtol})")
    return float(d.max())


def tp_flash(torch, gen, *, H, Dq, Dv, what):
    """One rank's heads (``H``, K and V heads alike) of a causal prefill of
    TP_ROWS x TP_SEQ, each of TP_MODEL simulated ranks' own seeded
    inputs: the kernel against the plain version.  Returns the row."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    errs = []
    for r in range(TP_MODEL):
        q, k = (torch.randn((TP_ROWS, TP_SEQ, H, Dq), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        v = torch.randn((TP_ROWS, TP_SEQ, H, Dv), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        errs.append(tp_held(f"flash_prefill {what} rank {r}",
                            flash_prefill_cuda(q, k, v),
                            flash_prefill_plain(q, k, v), "bfloat16",
                            FLASH_TOL))
    row = _row(errs, time_ms(torch, lambda: flash_prefill_cuda(q, k, v)),
               time_ms(torch, lambda: flash_prefill_plain(q, k, v)),
               flash_bound_ms(TP_SEQ, H, H, Dq, 0, 2, "bfloat16", Dv,
                              B=TP_ROWS),
               f"{what}: B {TP_ROWS}, S {TP_SEQ}, H = Hkv = {H}, Dq {Dq}, "
               f"Dv {Dv}, bf16, causal",
               library_ms=time_ms(torch, lambda: sdpa(torch, q, k, v)))
    _log_row(f"flash_prefill ({TP_MODEL} ranks)", row)
    return row


def sdpa(torch, q, k, v):
    """PyTorch's attention call over (B, S, H, D) operands: the library
    yardstick (timed, used nowhere in the port)."""
    f = torch.nn.functional.scaled_dot_product_attention
    return f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             is_causal=True)


def tp_ssm(torch, gen):
    """falcon-mamba-7b's scan over TP_ROWS x TP_SEQ at d_inner / TP_MODEL
    channels a rank: each simulated rank's channels of one seeded input
    through the kernel, against the same channels of the plain version
    over all of them (the scan is independent per channel)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    d, N = FALCON["d_inner"], FALCON["N"]
    n = d // TP_MODEL

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale)

    u = randn(TP_ROWS, TP_SEQ, d).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(TP_ROWS, TP_SEQ, d) - 4.6
                                      ).to(torch.bfloat16)
    A = -torch.exp(randn(d, N, scale=0.5))
    Bm, Cm = (randn(TP_ROWS, TP_SEQ, N).to(torch.bfloat16)
              for _ in range(2))
    want_y, want_h = ssm_scan_plain(u, dt, A, Bm, Cm)
    errs = []
    for r in range(TP_MODEL):
        sl = slice(r * n, (r + 1) * n)
        args = (u[..., sl].contiguous(), dt[..., sl].contiguous(),
                A[sl].contiguous(), Bm, Cm)
        y, h = ssm_scan_cuda(*args)
        errs.append(max(tp_held(f"ssm_scan rank {r} y", y, want_y[..., sl],
                                "bfloat16", SSM_TOL),
                        tp_held(f"ssm_scan rank {r} h", h, want_h[:, sl],
                                "bfloat16", SSM_TOL)))
    row = _row(errs, time_ms(torch, lambda: ssm_scan_cuda(*args)),
               time_ms(torch, lambda: ssm_scan_plain(*args)),
               ssm_bound_ms(args + (None,)),
               f"falcon-mamba-7b: B {TP_ROWS}, S {TP_SEQ}, d {n} of {d}, "
               f"N {N}, bf16")
    _log_row(f"ssm_scan ({TP_MODEL} ranks)", row)
    return row


def tp_ring(torch, gen, *, H, Hkv, Dh, same=False):
    """A TP_ROWS-row ring of TP_RING slots (rows TP_RING_LENS long), K and
    V of Hkv heads (``same``: one latent pool as both) and a query of H
    heads, bf16; (q, K, V, identity table, lens)."""
    q = torch.randn((TP_ROWS, H, Dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((TP_ROWS, TP_RING, Hkv, Dh), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    v = k if same else torch.randn(k.shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
    table = torch.arange(TP_ROWS, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.tensor(TP_RING_LENS, dtype=torch.int32, device="cuda")
    return q, k, v, table, lens


def tp_head_parallel(torch, gen):
    """qwen2-moe-a2.7b's decode at 1 head a rank: each simulated rank's
    query head against its KV head of a TP_RING-slot ring, the kernel
    against the plain version."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    q, k, v, table, lens = tp_ring(torch, gen, H=16, Hkv=16, Dh=128)
    errs = []
    for r in range(TP_MODEL):
        args = (q[:, r:r + 1].contiguous(), k[:, :, r:r + 1].contiguous(),
                v[:, :, r:r + 1].contiguous(), table, lens)
        errs.append(tp_held(f"head-parallel paged_attention rank {r}",
                            paged_attention_cuda(*args),
                            paged_attention_plain(*args), "bfloat16",
                            TP_HEAD_TOL))
    row = _row(errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
               time_ms(torch, lambda: paged_attention_plain(*args)),
               paged_bound_ms(list(args), sum(TP_RING_LENS), "bfloat16"),
               f"qwen2-moe-a2.7b head-parallel: B {TP_ROWS}, 1 head of 16, "
               f"Dh 128, a {TP_RING}-slot ring")
    _log_row(f"paged_attention ({TP_MODEL} ranks)", row)
    log(f"    each rank's o within {row['max_abs_err']:.3e} of the plain "
        f"version's (atol, rtol {TP_HEAD_TOL['bfloat16']})")
    return row


def lse_bound_ms(q, k, same, n_valid):
    """A slice call's least time: q, the valid ring rows of K and V (one
    pool where ``same``) read once, the f32 output and lse written once;
    4 FLOPs a (head, valid row, element)."""
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    nbytes = ((1 if same else 2) * n_valid * Hkv * Dh * 2 + q.numel() * 2
              + B * H * Dh * 4 + B * H * 4)
    flops = 4 * n_valid * H * Dh
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def tp_wrong_merges(fold_partials, os_, ls, want):
    """The errors against ``want`` of two faulty merges that the merge check
    must refuse: one that drops a middle rank's slice (the short rows,
    empty there, keep their keys), and one that ignores the lse and weighs
    every non-empty slice alike."""
    mid = os_.shape[0] // 2
    keep = [j for j in range(os_.shape[0]) if j != mid]
    drop = fold_partials(os_[keep], ls[keep])
    alike = fold_partials(os_, ls.masked_fill(ls.isfinite(), 0.0))
    return (float((drop - want).abs().max()),
            float((alike - want).abs().max()))


def tp_context_parallel(torch, gen, *, H, Hkv, Dh, same, what):
    """A TP_RING-slot ring cut into TP_MODEL slices, one a simulated rank:
    each slice's (o, lse) from the kernel with ``lse_out``, o (f32) within
    TP_MERGE_ATOL (the note above it) of the plain version's in f32 and
    lse within TP_LSE_ATOL, the short row's empty slices -inf with zeros
    and no NaN; the slices merged on the card (``fold_partials``) within
    TP_MERGE_ATOL of the plain whole-ring call and of the kernel's, both
    with ``lse_out``; two faulty merges (:func:`tp_wrong_merges`) outside
    it.  Timed: one slice whose every
    row is full (TP_RING / TP_MODEL valid slots)."""
    from repro_torch.distributed.tensor_parallel import fold_partials
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain,
                                                     takes_latent_kernel)
    q, k, v, table, lens = tp_ring(torch, gen, H=H, Hkv=Hkv, Dh=Dh,
                                   same=same)
    n = TP_RING // TP_MODEL
    p_type = "bf16" if takes_latent_kernel(q, k, v) else "f32"
    limit = TP_MERGE_ATOL[p_type]

    def ref(qq, kk, vv, *rest, lse_out):
        return paged_attention_plain(qq.float(), kk.float(), vv.float(),
                                     *rest, lse_out=lse_out)

    def with_lse(fn, kk, vv, sl):
        lse = torch.empty((TP_ROWS, H), dtype=torch.float32, device="cuda")
        return fn(q, kk, vv, table, sl, None, lse_out=lse), lse

    def piece(t, r):
        return t[:, r * n:(r + 1) * n].contiguous()

    def slices(fn):
        os_, ls = [], []
        for r in range(TP_MODEL):
            ks = piece(k, r)
            o, lse = with_lse(fn, ks, ks if same else piece(v, r),
                              (lens - r * n).clamp(0, n).to(torch.int32))
            os_.append(o)
            ls.append(lse)
        return torch.stack(os_), torch.stack(ls)

    got_o, got_l = slices(paged_attention_cuda)
    want_o, want_l = slices(ref)
    empty = want_l == -math.inf
    empty_ok = (bool(empty.any())
                and bool((got_l[empty] == -math.inf).all())
                and bool((got_o[empty] == 0).all())
                and not bool(got_o.isnan().any()))
    lse_err = float((got_l[~empty] - want_l[~empty]).abs().max())
    slice_err = float((got_o - want_o).abs().max())
    merged = fold_partials(got_o, got_l)
    whole = with_lse(paged_attention_cuda, k, v, lens)[0]
    plain = with_lse(ref, k, v, lens)[0]
    merge_err = float((merged - plain).abs().max())
    whole_err = float((merged - whole).abs().max())
    wrong = tp_wrong_merges(fold_partials, got_o, got_l, plain)
    # timed: a slice whose every row holds n valid slots, as a rank's
    # slice of a steady-state ring does
    ks = piece(k, 0)
    vs = ks if same else piece(v, 0)
    full = torch.full((TP_ROWS,), n, dtype=torch.int32, device="cuda")
    args = (q, ks, vs, table, full, None)
    lse = torch.empty((TP_ROWS, H), dtype=torch.float32, device="cuda")
    full_err = float((paged_attention_cuda(*args, lse_out=lse)
                      - ref(*args, lse_out=lse)).abs().max())
    log(f"    {what}: against the plain version in f32 (the kernel's P "
        f"in {p_type}): each slice's o within {slice_err:.3e} and its lse "
        f"within {lse_err:.3e}; the merge within {merge_err:.3e} of the "
        f"plain whole-ring call and {whole_err:.3e} of the kernel's; a "
        f"full slice within {full_err:.3e} (limits {limit:g}, lse "
        f"{TP_LSE_ATOL:g}); a merge dropping a middle rank's slice misses "
        f"by {wrong[0]:.3e}, one weighing the slices alike by "
        f"{wrong[1]:.3e}; {int(empty.sum())} empty (row, head) slices "
        f"{'gave' if empty_ok else 'did NOT give'} -inf and zeros")
    if not empty_ok:
        raise AssertionError(f"engine tp {what}: an empty slice did not "
                             f"give lse -inf and zeros")
    if lse_err > TP_LSE_ATOL:
        raise AssertionError(f"engine tp {what}: a slice's lse is "
                             f"{lse_err} from the plain version's")
    if not all(e <= limit for e in (slice_err, merge_err, whole_err,
                                    full_err)):
        raise AssertionError(
            f"engine tp {what}: slice o {slice_err}, merge vs plain "
            f"{merge_err}, vs the whole-ring call {whole_err}, full slice "
            f"{full_err} (limit {limit})")
    if not min(wrong) > limit:
        raise AssertionError(f"engine tp {what}: a faulty merge misses by "
                             f"only {min(wrong)}: the check cannot tell it")
    row = _row([slice_err, merge_err, whole_err, full_err],
               time_ms(torch, lambda: paged_attention_cuda(
                   *args, lse_out=lse)),
               time_ms(torch, lambda: paged_attention_plain(
                   *args, lse_out=lse)),
               lse_bound_ms(q, ks, same, TP_ROWS * n),
               f"{what}: one rank's full slice with lse_out, B {TP_ROWS}, "
               f"H {H} over Hkv {Hkv} (G {H // Hkv}), Dh {Dh}, {n} of "
               f"{TP_RING} slots a row, bf16")
    row.update(lse_max_abs_err=lse_err, empty_slices=int(empty.sum()),
               wrong_merge_errs=list(wrong))
    _log_row(f"paged_attention lse_out ({TP_MODEL} slices)", row)
    return row


# the tp path's training half: qwen2-moe-a2.7b at full width, TRAIN_LAYERS
# deep, f32, the train path's weights and batches (TRAIN_BATCH x
# TRAIN_SEQ), TP_TRAIN_STEPS steps of ``train_loop.train`` with
# ``Model(tp=...)`` on the world of one and ``cfg.remat`` set, against the
# same steps of the kernel trainer without tp and without remat.  Where
# the two are not bitwise, the losses are held within TP_TRAIN_LOSS_RTOL
# (relative) and step 0's gradients within TP_TRAIN_GRAD_TOL of each
# leaf's largest |gradient|
TP_TRAIN_STEPS = 2
TP_TRAIN_LOSS_RTOL = 1e-6
TP_TRAIN_GRAD_TOL = 1e-5
# the train path's peak card memory (max_memory_allocated, f32, 3 steps;
# PR 26's and PR 29's runs on the H100), printed beside the tp runs'
TRAIN_PEAK_GIB = 60.74
# the backward kernels at a rank's shapes of the production mesh's
# 'model' = TP_MODEL, f32: flash_prefill_bwd at TP_ROWS x TP_SEQ (qwen2-
# moe-a2.7b's 1 head of 16; deepseek-v3's 8 of 128 at Dq 192, Dv 128),
# expert_ffn_bwd over a rank's TP_FFN_SLOTS of qwen's 64 expert slots at
# TP_FFN_ROWS rows each, ssm_scan_bwd over 512 of falcon-mamba-7b's 8192
# channels; each held to its plain version on the inputs of the
# simulated ranks TP_BWD_RANKS (BWD_TOL of each gradient's scale), the
# last one's inputs timed
TP_FFN_SLOTS, TP_FFN_ROWS = 4, 512
TP_BWD_RANKS = (0, TP_MODEL - 1)


def tp_train_inputs(torch, cfg, dev, kept, seed):
    """The train path's (params on the card, batches, its peak memory) when
    it ran first, else drawn the same way."""
    held = kept.pop("qwen_f32", None)
    if held is not None and held[0] == cfg:
        return held[1], held[2], held[3], "the train path's"
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, make_batch
    dc = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    return (Model(cfg, torch.float32, device=dev).init(seed),
            [make_batch(dc, step) for step in range(TRAIN_STEPS)], None,
            f"drawn from seed {seed}")


def tp_train_diagnose(torch, tp_model, local, params, batch):
    """Where a tp run parts from the local one: each piece of the step on
    its own, bitwise or not (step 0's batch)."""
    import dataclasses
    from repro_torch.models.layers import (cross_entropy_loss,
                                           vocab_parallel_cross_entropy)
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import grads_of
    cfg = local.cfg
    out = []
    with torch.no_grad():
        a = tp_model.logits_full(params, batch, with_aux=True, caches=False)
        b = local.logits_full(params, batch, with_aux=True, caches=False)
    out.append(("the forward's logits and aux (moe_dist and tp vs local)",
                bool(torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]))))
    logits = b[0][:, :-1].detach().requires_grad_()
    labels = batch["tokens"][:, 1:]
    mask = batch["loss_mask"][:, 1:].float()
    ce_tp = vocab_parallel_cross_entropy(logits, labels, mask,
                                         cfg.vocab_size, tp_model.tp)
    ce_l = cross_entropy_loss(logits, labels, mask, cfg.vocab_size)
    g_tp, = torch.autograd.grad(ce_tp, logits)
    g_l, = torch.autograd.grad(ce_l, logits)
    out.append(("vocab_parallel_cross_entropy vs cross_entropy_loss, value "
                "and gradient", bool(torch.equal(ce_tp, ce_l)
                                     and torch.equal(g_tp, g_l))))
    del a, b, logits, g_tp, g_l

    def grads(m):
        return dict(flatten(grads_of(m, params, batch)[3]))
    want = grads(local)
    for what, m in (
            ("cfg.remat alone (local model)",
             Model(dataclasses.replace(cfg, remat=True), torch.float32,
                   device=local.device)),
            ("moe_dist alone (no tp, no remat)",
             Model(cfg, torch.float32, device=local.device,
                   moe_dist=tp_model.moe_dist))):
        got = grads(m)
        out.append((what + ": step 0's gradients",
                    all(torch.equal(got[k], want[k]) for k in want)))
        del got
    return out


def tp_train(torch, cfg, mesh, dev, kept, seed):
    """The tp path's training half (the note above TP_TRAIN_STEPS).
    Returns the tp run's launch counts."""
    import dataclasses
    from repro_torch.distributed.collectives import make_moe_dist
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import grads_of, train
    params, batches, train_peak, source = tp_train_inputs(torch, cfg, dev,
                                                          kept, seed)
    batches = batches[:TP_TRAIN_STEPS]
    opt = OptimizerConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    remat = dataclasses.replace(cfg, remat=True)
    # the fused local compute has no backward: the layer's plain dispatch
    md = make_moe_dist(mesh, cfg.moe_impl.replace("_fused", ""))
    md.place(TRAIN_BATCH)
    tp = TensorParallel(mesh, ShardingRules(mesh, remat))
    rows = tp.place(TRAIN_BATCH)
    if (tp.world, rows) != (1, slice(0, TRAIN_BATCH)):
        raise AssertionError(f"engine tp: a world of {tp.world}")
    # a world of one's tp_shard of each leaf is the whole leaf
    tp_model = Model(remat, torch.float32, device=dev, moe_dist=md, tp=tp)
    local = Model(cfg, torch.float32, device=dev)
    log(f"  training: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"f32 ({source} weights and batches), {TP_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens with Model(tp=...), moe_dist "
        f"{md.name} and cfg.remat on the world of one, against the kernel "
        f"trainer without tp and without remat")
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}

    def peak_over(fn, held=()):
        """``fn()`` and its peak bytes on the card, less the bytes of the
        tensors in ``held`` (the other run's, kept for the comparison):
        each run's own peak, its initial params included."""
        _free(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated()
                     - sum(t.numel() * t.element_size() for t in held))

    def leaf_errs(got, want, relative):
        """Per leaf max |got - want| (over max |want| with
        ``relative``), on the card."""
        out = {}
        for k, w in want.items():
            d = float((got[k] - w).abs().max())
            out[k] = d / max(float(w.abs().max()), 1e-30) if relative else d
        return out

    # both runs' step 0 gradients side by side on the card, then each
    # run's steps, the first run's params kept on the card: no host copy
    g_tp, gpeak_tp = peak_over(lambda: dict(flatten(
        grads_of(tp_model, params, b0)[3])))
    g_l, gpeak_l = peak_over(lambda: dict(flatten(
        grads_of(local, params, b0)[3])), g_tp.values())
    g_err = leaf_errs(g_tp, g_l, True)
    del g_tp, g_l
    before = dict(launches)
    (p_tp, h_tp), peak_tp = peak_over(lambda: train(
        tp_model, iter(batches), TP_TRAIN_STEPS, opt, log_every=1,
        params=params))
    counts = {k: v - before.get(k, 0) for k, v in launches.items()
              if v != before.get(k, 0)}
    p_tp = dict(flatten(p_tp))
    (p_l, h_l), peak_l = peak_over(lambda: train(
        local, iter(batches), TP_TRAIN_STEPS, opt, log_every=1,
        params=params), p_tp.values())
    p_err = leaf_errs(p_tp, dict(flatten(p_l)), False)
    del p_tp, p_l
    same_loss = all(a[k] == b[k] for a, b in zip(h_tp, h_l)
                    for k in ("loss", "ce", "aux", "grad_norm"))
    bitwise = same_loss and not any(g_err.values()) and not any(
        p_err.values())
    for i, (a, b) in enumerate(zip(h_tp, h_l)):
        log(f"    step {i}: tp loss {a['loss']!r} ce {a['ce']!r} aux "
            f"{a['aux']!r} grad_norm {a['grad_norm']!r} ({a['elapsed_s']:.3f} "
            f"s since the start); local loss {b['loss']!r} ce {b['ce']!r} "
            f"aux {b['aux']!r} grad_norm {b['grad_norm']!r} "
            f"({b['elapsed_s']:.3f} s)")
    worst = sorted(g_err.items(), key=lambda kv: -kv[1])[:3]
    log(f"    the two runs {'ARE' if bitwise else 'are NOT'} bitwise equal: "
        f"losses {'equal' if same_loss else 'differ'}; step 0's gradients, "
        f"largest |d| / max |g| of a leaf: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst)
        + f"; params after step {TP_TRAIN_STEPS}: largest |d| "
        f"{max(p_err.values()):.3e} ({max(p_err, key=p_err.get)})")
    train_gib = (f"{train_peak / 2**30:.2f} GiB in this run's train path, "
                 if train_peak else "")
    log(f"    max_memory_allocated over the {TP_TRAIN_STEPS} steps: tp with "
        f"remat {peak_tp / 2**30:.2f} GiB, local without remat "
        f"{peak_l / 2**30:.2f} GiB (the train path's 3 steps: "
        f"{train_gib}{TRAIN_PEAK_GIB} GiB in PR 29's run); over step 0's "
        f"forward and backward alone (grads_of, no update): tp with remat "
        f"{gpeak_tp / 2**30:.2f} GiB, local {gpeak_l / 2**30:.2f} GiB")
    if not bitwise:
        for what, same in tp_train_diagnose(torch, tp_model, local, params,
                                            b0):
            log(f"    {what}: {'bitwise' if same else 'DIFFERS'}")
        for i, (a, b) in enumerate(zip(h_tp, h_l)):
            for k in ("loss", "ce", "aux", "grad_norm"):
                if not (math.isfinite(a[k]) and abs(a[k] - b[k])
                        <= TP_TRAIN_LOSS_RTOL * abs(b[k])):
                    raise AssertionError(f"engine tp train: step {i} {k} "
                                         f"{a[k]!r} against {b[k]!r}")
        bad = {k: v for k, v in g_err.items() if not v <= TP_TRAIN_GRAD_TOL}
        if bad:
            raise AssertionError(f"engine tp train: step 0's gradients off: "
                                 f"{bad}")
    L = cfg.num_layers
    moe = local._num_moe_layers()
    want = {"flash_prefill_bwd": L * TP_TRAIN_STEPS,
            "expert_ffn_bwd": moe * TP_TRAIN_STEPS}
    log(f"    the tp run's launches {counts} (remat: flash_prefill "
        f"{counts.get('flash_prefill', 0)} for {L * TP_TRAIN_STEPS} "
        f"layer-steps)")
    if ({k: counts.get(k, 0) for k in want} != want
            or counts.get("flash_prefill", 0) < 2 * L * TP_TRAIN_STEPS):
        raise AssertionError(f"engine tp train: launches {counts}, expected "
                             f"{want} and flash_prefill recomputed")
    del params, batches, tp_model, local, b0
    _free(torch)
    return counts


def tp_flash_bwd(torch, *, H, Dq, Dv, what, seed):
    """flash_prefill_bwd at one rank's heads (``H``, K and V heads alike)
    of a causal TP_ROWS x TP_SEQ prefill, f32, against the plain version
    for each of TP_BWD_RANKS' seeded inputs; timed with the library's
    backward (``autograd.grad`` through scaled_dot_product_attention)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_bwd_cuda,
                                                   flash_prefill_bwd_plain,
                                                   flash_prefill_cuda)
    B, S = TP_ROWS, TP_SEQ
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    errs = []
    for r in TP_BWD_RANKS:
        gen = torch.Generator(device="cuda").manual_seed(seed + r)
        q, k, v, do = (torch.randn(sh, generator=gen, device="cuda")
                       for sh in ((B, S, H, Dq), (B, S, H, Dq), (B, S, H, Dv),
                                  (B, S, H, Dv)))
        o = flash_prefill_cuda(q, k, v, pos, pos, causal=True, window=0)
        got = flash_prefill_bwd_cuda(q, k, v, o, do, pos, pos, causal=True,
                                     window=0)
        want = flash_prefill_bwd_plain(q, k, v, o, do, pos, pos,
                                       causal=True, window=0)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs.append(_scaled_err(f"flash_prefill_bwd {what} rank {r} "
                                    f"{name}", g, w, "float32"))
        del got, want
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)
    row = _row(errs, time_ms(torch, lambda: flash_prefill_bwd_cuda(
                   q, k, v, o, do, pos, pos)),
               time_ms(torch, lambda: flash_prefill_bwd_plain(
                   q, k, v, o, do, pos, pos)),
               flash_bwd_bound_ms(B, S, H, H, Dq, Dv, 0, 4, "float32"),
               f"{what}: B {B}, S {S}, H = Hkv = {H}, Dq {Dq}, Dv {Dv}, "
               f"f32, causal (library: autograd.grad through "
               f"scaled_dot_product_attention)",
               library_ms=time_ms(torch, lambda: torch.autograd.grad(
                   o_lib, (qt, kt, vt), do_t, retain_graph=True)))
    _log_row(f"flash_prefill_bwd (a rank of {TP_MODEL})", row)
    del q, k, v, o, do, qt, kt, vt, o_lib
    _free(torch)
    return row


def tp_ffn_bwd(torch, seed):
    """expert_ffn_bwd over a rank's TP_FFN_SLOTS expert slots of
    qwen2-moe-a2.7b at TP_FFN_ROWS rows each, f32, against the plain
    version for each of TP_BWD_RANKS' seeded inputs; timed with the
    library's backward (``autograd.grad`` through silu(bmm) * bmm, then
    bmm)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_bwd_cuda,
                                                expert_ffn_bwd_plain)
    E, C, D, Fd = TP_FFN_SLOTS, TP_FFN_ROWS, QWEN["D"], QWEN["F"]
    errs = []
    for r in TP_BWD_RANKS:
        gen = torch.Generator(device="cuda").manual_seed(seed + r)
        x = torch.randn((E, C, D), generator=gen, device="cuda")
        g, u = (torch.randn((E, D, Fd), generator=gen, device="cuda")
                / math.sqrt(D) for _ in range(2))
        d = torch.randn((E, Fd, D), generator=gen, device="cuda") \
            / math.sqrt(Fd)
        dy = torch.randn((E, C, D), generator=gen, device="cuda")
        got = expert_ffn_bwd_cuda(x, g, u, d, dy)
        want = expert_ffn_bwd_plain(x, g, u, d, dy)
        for name, a, w in zip(("dx", "dgate", "dup", "ddown"), got, want):
            errs.append(_scaled_err(f"expert_ffn_bwd rank {r} {name}", a, w,
                                    "float32"))
        del got, want
    ts = [t.detach().requires_grad_() for t in (x, g, u, d)]
    y_lib = torch.bmm(F.silu(torch.bmm(ts[0], ts[1]))
                      * torch.bmm(ts[0], ts[2]), ts[3])
    row = _row(errs, time_ms(torch, lambda: expert_ffn_bwd_cuda(
                   x, g, u, d, dy)),
               time_ms(torch, lambda: expert_ffn_bwd_plain(x, g, u, d, dy)),
               ffn_bwd_bound_ms(E, C, C, D, Fd, 4, "float32"),
               f"qwen2-moe-a2.7b: {E} of 64 expert slots, C {C} rows each, "
               f"D {D}, F {Fd}, f32 (library: autograd.grad through "
               f"silu(bmm) * bmm, then bmm)",
               library_ms=time_ms(torch, lambda: torch.autograd.grad(
                   y_lib, ts, dy, retain_graph=True)))
    _log_row(f"expert_ffn_bwd (a rank of {TP_MODEL})", row)
    del x, g, u, d, dy, ts, y_lib
    _free(torch)
    return row


def tp_ssm_bwd(torch, seed):
    """ssm_scan_bwd over a rank's d_inner / TP_MODEL of falcon-mamba-7b's
    channels, TP_ROWS x TP_SEQ, f32, against the plain version for each of
    TP_BWD_RANKS' seeded inputs (no library call computes a selective
    scan's gradient)."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda,
                                              ssm_scan_bwd_plain)
    d = FALCON["d_inner"] // TP_MODEL
    errs = []
    for r in TP_BWD_RANKS:
        args = ssm_case(torch, TP_ROWS, TP_SEQ, with_h0=False,
                        dtype=torch.float32, seed=seed + r, d=d)[:5]
        dy = torch.randn((TP_ROWS, TP_SEQ, d), generator=torch.Generator(
            device="cuda").manual_seed(seed + 100 + r), device="cuda")
        got = ssm_scan_bwd_cuda(*args, dy)
        want = ssm_scan_bwd_plain(*args, dy)
        for name, g, w in zip(("du", "ddt", "dA", "dB", "dC"), got, want):
            errs.append(_scaled_err(f"ssm_scan_bwd rank {r} {name}", g, w,
                                    "float32"))
        del got, want
    row = _row(errs, time_ms(torch, lambda: ssm_scan_bwd_cuda(*args, dy)),
               time_ms(torch, lambda: ssm_scan_bwd_plain(*args, dy)),
               ssm_bwd_bound_ms(args, dy, None),
               f"falcon-mamba-7b: B {TP_ROWS}, S {TP_SEQ}, d {d} of "
               f"{FALCON['d_inner']}, N {FALCON['N']}, f32 (library: none)")
    _log_row(f"ssm_scan_bwd (a rank of {TP_MODEL})", row)
    del args, dy
    _free(torch)
    return row


def serve_tp(torch, cfg, path, workdir, seed, profile, kept):
    """The ``tp`` path (no engine; the notes above TP_ROWS and
    TP_TRAIN_STEPS).  Returns the world-of-one runs' launch counts."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.kernels.paged_attention import LSE
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group = kept.pop("nccl", None)
    store = None
    if group is None:
        workdir.mkdir(parents=True, exist_ok=True)
        store = workdir / "nccl_store_tp"
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", rank=0, world_size=1,
                                store=dist.FileStore(str(store), 1),
                                device_id=dev)
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    else:
        mesh = group
    lap = laps("engine tp")
    try:
        held = kept.pop("qwen_bf16", None)
        t0 = time.perf_counter()
        params = (held[1] if held is not None and held[0] == cfg else
                  Model(cfg, torch.bfloat16, device=dev).init(seed))
        torch.cuda.synchronize()
        log(f"engine: path {path!r}: the tensor-parallel serve steps on a "
            f"world of one under NCCL ({'the dist path' if group else 'its'}"
            f" process group), {cfg.name} at full width, {cfg.num_layers} "
            f"layers, bf16 (weights "
            + ("of the dist path" if held is not None else
               f"from seed {seed} in {time.perf_counter() - t0:.1f} s")
            + f"): {TP_ROWS} x {TP_SEQ} tokens, then {TP_STEPS} decode "
            f"steps, with tp and without")
        tokens = torch.from_numpy(np.random.default_rng(seed + 41).integers(
            0, cfg.vocab_size, (TP_ROWS, TP_SEQ))).to(dev)
        counts = tp_world_of_one(torch, cfg, params, mesh, dev, tokens,
                                 TP_SEQ + TP_STEPS, cfg.name)
        del params
        _free(torch)
        mla = dataclasses.replace(get_config(TP_MLA_ARCH), num_layers=2)
        p = Model(mla, torch.bfloat16, device=dev).init(seed)
        tokens = torch.from_numpy(np.random.default_rng(seed + 42).integers(
            0, mla.vocab_size, (TP_ROWS, TP_MLA_SEQ))).to(dev)
        more = tp_world_of_one(torch, mla, p, mesh, dev, tokens,
                               TP_MLA_SEQ + TP_STEPS, mla.name)
        if more.get(LSE, 0) <= 0:
            raise AssertionError(f"engine tp {mla.name}: no lse_out launch")
        for k, v in more.items():
            counts[k] = counts.get(k, 0) + v
        del p
        _free(torch)
        lap("serve steps, world of one")
        for k, v in tp_train(torch, cfg, mesh, dev, kept, seed).items():
            counts[k] = counts.get(k, 0) + v
        lap("train steps, world of one")
    finally:
        dist.destroy_process_group()
        if store is not None:
            store.unlink(missing_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    log(f"  the kernels at a rank's shapes of the production mesh's "
        f"'model' = {TP_MODEL}, at full width: {TP_MODEL} simulated ranks "
        f"one after the other on this one card (their launches are "
        f"checks, not counted)")
    before = dict(launches)
    TP_RESULTS["flash_prefill"] = {
        "qwen": tp_flash(torch, gen, H=1, Dq=128, Dv=128,
                         what="qwen2-moe-a2.7b"),
        "deepseek": tp_flash(torch, gen, H=8, Dq=192, Dv=128,
                             what="deepseek-v3")}
    TP_RESULTS["ssm_scan"] = tp_ssm(torch, gen)
    TP_RESULTS["paged_attention"] = {
        "head_parallel": tp_head_parallel(torch, gen),
        "lse_gqa": tp_context_parallel(torch, gen, H=48, Hkv=8, Dh=128,
                                       same=False, what="internlm2-20b"),
        "lse_latent": tp_context_parallel(torch, gen, H=128, Hkv=1,
                                          Dh=576, same=True,
                                          what="deepseek-v3 latent")}
    lap("forward kernels at a rank's shapes")
    log(f"  the backward kernels at a rank's shapes of 'model' = {TP_MODEL}, "
        f"f32, each held to its plain version on the inputs of simulated "
        f"ranks {TP_BWD_RANKS}")
    TP_RESULTS["flash_prefill_bwd"] = {
        "qwen": tp_flash_bwd(torch, H=1, Dq=128, Dv=128,
                             what="qwen2-moe-a2.7b", seed=seed + 44),
        "deepseek": tp_flash_bwd(torch, H=8, Dq=192, Dv=128,
                                 what="deepseek-v3", seed=seed + 46)}
    TP_RESULTS["expert_ffn_bwd"] = tp_ffn_bwd(torch, seed + 48)
    TP_RESULTS["ssm_scan_bwd"] = tp_ssm_bwd(torch, seed + 50)
    lap("backward kernels at a rank's shapes")
    for k in list(launches):
        launches[k] = before.get(k, 0)
    TP_RESULTS["paged_attention"]["lse_launches"] = counts.get(LSE, 0)
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine tp: launches {counts}")
    return {k: counts[k] for k in used}, None, None


SERVE = {"disagg": serve_disagg, "fleet": serve_fleet, "spec": serve_spec,
         "spec_megakernel": serve_spec, "overlap": serve_overlap,
         "http": serve_http_path, "vlm": serve_ring, "audio": serve_ring,
         "train": serve_train, "train_ssm": serve_train,
         "examples": serve_examples,
         "dist": serve_dist, "dryrun": serve_dryrun, "tp": serve_tp}


# -- main ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--layers", type=int, default=COLLOCATED_LAYERS,
                    help="depth of the qwen paths (at most "
                         f"{ENGINE_LAYERS})")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="engine paths to serve, of " + ", ".join(PATHS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace each engine run without a fault")
    args = ap.parse_args()
    phases = args.phases.split(",")
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}; phases: {PHASES}")
    for p in args.paths.split(","):
        if p not in PATHS:
            raise SystemExit(f"unknown path {p!r}; paths: {tuple(PATHS)}")

    # the engine phase builds and frees ~30 GB models one after another:
    # growable segments keep the freed memory from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    phase_device(torch)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch import hardware
    global HBM_BYTES_PER_S, PEAK_FLOPS
    HBM_BYTES_PER_S, PEAK_FLOPS = hardware.HBM_BYTES_PER_S, \
        hardware.PEAK_FLOPS
    t_start = time.perf_counter()
    took = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        took[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name} passed in {took[name]} s")
        return out

    if "build" in phases:
        timed("build", phase_build)
    results = {}
    if "kernels" in phases:
        results = timed("kernels", lambda: phase_kernels(torch, SHAPES))
    if "model" in phases:
        timed("model", lambda: phase_model(torch, args.seed))
    counts, by_path = {}, {}
    if "engine" in phases:
        counts, by_path = timed("engine", lambda: phase_engine(
            torch, args.seed, args.layers, args.paths.split(","),
            args.profile))
    log(f"phases {phases} passed in {time.perf_counter() - t_start:.1f} s "
        f"({json.dumps(took)})")
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = results.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts.get(name, 0),
            launches_by_path=by_path.get(name, {}),
            max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), shape=r.get("shape"),
            mla=r.get("mla"), dense=r.get("dense"),
            hybrid=r.get("hybrid"), ring=r.get("ring"), bf16=r.get("bf16"),
            tp=TP_RESULTS.get(name)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
