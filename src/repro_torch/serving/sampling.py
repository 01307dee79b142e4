"""Token sampling: greedy / temperature / top-p.

The host sampler of ``repro.serving.sampling`` (``sample`` and its
position-seeded uniforms) and the accept/reject of self-speculative
decode (``spec_verify``), copied; ``device_predict`` is the overlap
pipeline's sampling epilogue on the engine's device, as plain functions
on tensors."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 = greedy
    top_p: float = 1.0
    seed: int = 0


# ---------------------------------------------------------------------------
# Batched seeded uniforms.
#
# The sampler draws one uniform per row from
# ``np.random.default_rng(seed).random()`` where ``seed`` encodes the row's
# sequence position.  Constructing a Generator per row per step is the
# engine's host-side hot spot, so ``_seeded_uniforms`` replicates numpy's
# SeedSequence pool mixing + PCG64 seeding + first draw exactly — same bits
# out — as a handful of vectorized uint32/uint64 passes over all rows at
# once.  The hash-constant chains below are data-independent, so they are
# precomputed once at import (as Python ints, then narrowed to uint32).
# ---------------------------------------------------------------------------

_XSHIFT = np.uint32(16)
_MIX_L = np.uint32(0xCA01F9DD)           # SeedSequence MIX_MULT_L
_MIX_R = np.uint32(0x4973F715)           # SeedSequence MIX_MULT_R
_U32MASK = np.uint64(0xFFFFFFFF)
_PCG_MULT_HI = np.uint64(2549297995355413924)   # PCG64 128-bit multiplier
_PCG_MULT_LO = np.uint64(4865540595714422341)


def _hash_consts(init: int, mult: int, n: int):
    """(xor, mul) uint32 pairs for n chained SeedSequence hashmix calls."""
    out, hc = [], init
    for _ in range(n):
        nxt = (hc * mult) & 0xFFFFFFFF
        out.append((np.uint32(hc), np.uint32(nxt)))
        hc = nxt
    return out


# pool fill (4 calls) + pool mixing (12 calls) share one INIT_A chain;
# generate_state uses its own INIT_B chain (8 output words).
_HASH_A = _hash_consts(0x43B0D7E5, 0x931E8875, 16)
_HASH_B = _hash_consts(0x8B51F9DD, 0x58F38DED, 8)


def _seeded_uniforms(seeds: np.ndarray) -> np.ndarray:
    """One ``np.random.default_rng(int(s)).random()`` per entry, batched.

    Bit-identical to the per-row Generator construction for any seed that
    fits in uint64 (callers guard the range and fall back otherwise).
    """
    seeds = np.asarray(seeds, dtype=np.uint64)
    # -- SeedSequence: fill + mix the 4-word entropy pool.  Entropy is the
    # seed as [lo32, hi32]; absent words hash like explicit zeros, so every
    # seed < 2**64 takes this one code path.
    consts = iter(_HASH_A)

    def hashmix(v):
        xor_c, mul_c = next(consts)
        v = (v ^ xor_c) * mul_c
        return v ^ (v >> _XSHIFT)

    zero = np.zeros(seeds.shape, np.uint32)
    pool = [hashmix((seeds & _U32MASK).astype(np.uint32)),
            hashmix((seeds >> np.uint64(32)).astype(np.uint32)),
            hashmix(zero), hashmix(zero)]
    for i_src in range(4):
        for i_dst in range(4):
            if i_src == i_dst:
                continue
            r = pool[i_dst] * _MIX_L - hashmix(pool[i_src]) * _MIX_R
            pool[i_dst] = r ^ (r >> _XSHIFT)
    # -- SeedSequence.generate_state(4, uint64): 8 uint32 words, paired
    # little-endian into (initstate, initseq) 64-bit halves.
    w = []
    for i, (xor_c, mul_c) in enumerate(_HASH_B):
        v = (pool[i % 4] ^ xor_c) * mul_c
        w.append((v ^ (v >> _XSHIFT)).astype(np.uint64))
    sh = np.uint64(32)
    st_hi, st_lo = w[0] | (w[1] << sh), w[2] | (w[3] << sh)
    iq_hi, iq_lo = w[4] | (w[5] << sh), w[6] | (w[7] << sh)
    inc_hi = (iq_hi << np.uint64(1)) | (iq_lo >> np.uint64(63))
    inc_lo = (iq_lo << np.uint64(1)) | np.uint64(1)

    def mul_hilo(a, b):
        # full 64x64 -> 128-bit product via 32-bit limbs
        al, ah = a & _U32MASK, a >> sh
        bl, bh = b & _U32MASK, b >> sh
        ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
        mid = (ll >> sh) + (lh & _U32MASK) + (hl & _U32MASK)
        lo = (ll & _U32MASK) | ((mid & _U32MASK) << sh)
        return hh + (lh >> sh) + (hl >> sh) + (mid >> sh), lo

    def pcg_step(hi, lo):
        # state = state * MULT + inc  (mod 2**128)
        phi, plo = mul_hilo(lo, _PCG_MULT_LO)
        phi = phi + lo * _PCG_MULT_HI + hi * _PCG_MULT_LO
        lo2 = plo + inc_lo
        return phi + inc_hi + (lo2 < plo).astype(np.uint64), lo2

    hi = np.zeros(seeds.shape, np.uint64)
    lo = np.zeros(seeds.shape, np.uint64)
    hi, lo = pcg_step(hi, lo)                 # srandom: advance zero state
    lo2 = lo + st_lo
    hi, lo = hi + st_hi + (lo2 < lo).astype(np.uint64), lo2
    hi, lo = pcg_step(hi, lo)                 # srandom: second advance
    hi, lo = pcg_step(hi, lo)                 # the single .random() draw
    out = hi ^ lo                             # PCG64 XSL-RR output
    rot = hi >> np.uint64(58)
    out = (out >> rot) | (out << ((np.uint64(64) - rot) & np.uint64(63)))
    return (out >> np.uint64(11)) * (1.0 / 9007199254740992.0)


def seeded_uniforms(seed: int, steps: np.ndarray) -> np.ndarray:
    """Per-row uniforms for ``sample``: rng(seed*1_000_003 + step).random().

    Vectorized over rows when every derived seed fits in uint64; falls back
    to the reference per-row Generator path for exotic seeds.
    """
    steps = np.asarray(steps, np.int64)
    if steps.size == 0:
        return np.empty(0, np.float64)
    base = seed * 1_000_003
    lo_v, hi_v = base + int(steps.min()), base + int(steps.max())
    if 0 <= lo_v and hi_v < 2 ** 64:
        # wraparound addition is exact here: the true values are in range
        return _seeded_uniforms(np.uint64(base & 0xFFFFFFFFFFFFFFFF)
                                + steps.astype(np.uint64))
    return np.asarray([np.random.default_rng(base + int(s)).random()
                       for s in steps])


def sample(logits: np.ndarray, params: SamplingParams,
           step=0) -> np.ndarray:
    """logits: (B, V) -> (B,) int32 token ids.

    Deterministic given (seed, step) *per row*: each row's uniform is
    drawn from (seed, its step value) alone, so a request's token
    depends only on its own logits and step — not on its batch slot or
    on which other requests happen to be decoding alongside it.

    ``step`` may be a scalar (all rows share one draw, the pre-fleet
    behaviour) or a per-row array.  The serving executors pass each
    request's *sequence position* as its step, which makes the sampled
    token a pure function of (seed, prompt, position): a request
    replayed after migration — to another executor or to another fleet
    instance entirely — reproduces its original tokens exactly.
    """
    logits = np.asarray(logits, dtype=np.float64)
    if params.temperature <= 0.0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    steps = np.broadcast_to(np.asarray(step, np.int64), (logits.shape[0],))
    u = seeded_uniforms(params.seed, steps)
    z = logits / params.temperature
    z = z - z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    order = np.argsort(-p, axis=-1)
    sorted_p = np.take_along_axis(p, order, axis=-1)
    if params.top_p < 1.0:
        csum = np.cumsum(sorted_p, axis=-1)
        cut = csum - sorted_p > params.top_p
        sorted_p[cut] = 0.0
        sorted_p /= sorted_p.sum(axis=-1, keepdims=True)
    # per-row-u inverse CDF over the sorted distribution, vectorized
    cdf = np.cumsum(sorted_p, axis=-1)
    idx = np.minimum((cdf < u[:, None]).sum(axis=-1), logits.shape[-1] - 1)
    return np.take_along_axis(order, idx[:, None], axis=-1)[:, 0].astype(
        np.int32)


# ---------------------------------------------------------------------------
# Device-side predictive sampling (the overlap pipeline's readback).
#
# The overlapped executor does not wait for a step's logits before it
# launches the next: an epilogue on the device samples every window's
# tokens with the same math as `sample` (greedy argmax, or the seeded
# top-p inverse CDF in f32 against uniforms `seeded_uniforms` computed on
# the host), chains the chosen last tokens into a device-resident
# next-token vector, and its token ids come back with the logits.
# Greedy prediction is exact (argmax keeps the first maximum on both
# sides); at temperature > 0 the f32 CDF may part from the host's
# f64 one in its last ulp.  The host sampler re-derives every token from
# the drained logits and stays authoritative, so a disagreement costs a
# replan, never a wrong token.
# ---------------------------------------------------------------------------


def device_predict(logits: torch.Tensor, row0: torch.Tensor,
                   lens: torch.Tensor, drafts: torch.Tensor,
                   u: torch.Tensor, dev_last: torch.Tensor,
                   slots: torch.Tensor, *, temperature: float,
                   top_p: float):
    """Sample all windows of one step's logits on their device.

    logits: (R, V).  Per window i (of S, padded): ``row0[i]`` its first
    logits row, ``lens[i]`` rows used (0 = padding), ``drafts[i]`` (G,)
    the tokens forwarded (entry 0 unused), ``u[i]`` (G,) f32 uniforms,
    ``slots[i]`` its decode batch slot (out of range = dropped); every
    index int32 on ``logits``' device.  Returns ``(targets (S, G),
    accepted (S,), new_dev_last)``: each row's sampled token, the number
    of drafts matched, and a copy of ``dev_last`` with each window's
    emitted last token scattered in.  Nothing waits on the device."""
    dev = logits.device
    G = drafts.shape[1]
    idx = (row0.long()[:, None]
           + torch.arange(G, device=dev)[None, :]).clamp(
               0, logits.shape[0] - 1)
    rows = logits[idx].float()                      # (S, G, V)
    if temperature <= 0.0:
        targets = rows.argmax(dim=-1).int()
    else:
        z = rows / temperature
        z = z - z.amax(dim=-1, keepdim=True)
        p = torch.exp(z)
        p = p / p.sum(dim=-1, keepdim=True)
        # descending, ties by index: jnp.argsort(-p) is stable too
        sp, order = torch.sort(p, dim=-1, descending=True, stable=True)
        if top_p < 1.0:
            csum = sp.cumsum(dim=-1)
            sp = torch.where(csum - sp > top_p, torch.zeros_like(sp), sp)
            sp = sp / sp.sum(dim=-1, keepdim=True)
        cdf = sp.cumsum(dim=-1)
        k = (cdf < u[..., None]).sum(dim=-1).clamp(max=rows.shape[-1] - 1)
        targets = order.gather(-1, k[..., None])[..., 0].int()
    lens = lens.int()
    if G > 1:
        ok = targets[:, :-1] == drafts[:, 1:]
        live = (torch.arange(1, G, device=dev)[None, :] < lens[:, None])
        accepted = torch.cumprod((ok & live).int(), dim=1).sum(dim=1).int()
    else:
        accepted = torch.zeros_like(lens)
    accepted = torch.minimum(accepted, (lens - 1).clamp(min=0))
    last = targets.gather(1, accepted.long()[:, None])[:, 0]
    # a scatter into one spare entry past the end drops padding rows and
    # slots out of range (jnp's mode="drop"), with no host round trip
    n = dev_last.shape[0]
    safe = torch.where((lens > 0) & (slots < n), slots.long(), n)
    ext = torch.cat([dev_last.int(), dev_last.new_zeros(1, dtype=torch.int32)])
    ext.scatter_(0, safe, last)
    return targets, accepted, ext[:n]


def spec_verify(logits: np.ndarray, drafts, params: SamplingParams, *,
                start_step: int):
    """Deterministic accept/reject for self-speculative decode.

    ``logits`` (g, V) are the verifier's outputs for one speculation
    window: row r holds the logits for sequence position
    ``start_step + r`` (row 0 re-forwarded the last committed token;
    rows 1..g-1 forwarded ``drafts``).  Each row is sampled with the
    *same* seeded sampler a non-speculative decode step would use at
    that position, and a draft is accepted iff it equals the sampled
    target exactly — so the emitted stream is token-identical to plain
    decode, whatever the temperature.  Rows past the first mismatch
    conditioned on rejected drafts and are discarded.

    Returns ``(tokens, accepted)``: the emitted token ids (1 + accepted
    drafts; the final entry is the verifier's "bonus" token, fresh for
    the first rejected position or appended after a fully-accepted
    window) and the number of drafts accepted.
    """
    g = logits.shape[0]
    steps = start_step + np.arange(g, dtype=np.int64)
    targets = sample(logits, params, step=steps)
    accepted = 0
    for d in drafts:
        if accepted >= g - 1 or int(targets[accepted]) != int(d):
            break
        accepted += 1
    return targets[:accepted + 1], accepted
