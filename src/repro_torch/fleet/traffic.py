"""Open-loop traffic sources for the fleet router.

Open-loop means arrivals do not wait for the system: during a recovery
stall the arrival process keeps producing, the queue grows, and TTFT
degrades — which is exactly the client-visible cost the fleet benchmark
measures.  Closed-loop drivers (submit-on-completion) hide that cost.

Both sources yield :class:`Arrival` records against a caller-supplied
clock (wall seconds in benchmarks, synthetic seconds in tests), so runs
are reproducible given a seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Arrival:
    at_s: float                 # arrival time on the driver's clock
    prompt_tokens: Tuple[int, ...]
    max_new_tokens: int
    # multi-model fleets: which model config this request needs (None =
    # any instance may serve it)
    model_id: Optional[str] = None


class PoissonTraffic:
    """Memoryless open-loop arrivals at ``rate_per_s``, random prompts.

    ``prompt_len`` may be a single length or a sequence of choices (a
    mixed long/short workload — one is drawn per arrival).  With
    ``shared_prefix_len`` > 0, a fraction ``shared_fraction`` of
    arrivals start with one fixed random "system prompt" of that length
    — the prefix-cache-heavy production shape.

    ``length_dist="lognormal"`` replaces the fixed request shape with
    seeded heavy-tailed draws: the configured prompt length and
    ``max_new_tokens`` become the *medians* of lognormal distributions
    with log-space sigma ``length_sigma`` (prompt drawn first, then
    output, one pair per arrival), clamped to ``max_prompt_len`` /
    ``max_output_len`` when given.  Production traces are heavy-tailed
    — a few huge requests dominate queueing during recovery stalls —
    so campaigns should not score SLO burn against a uniform-shape
    fiction.  The default path (``length_dist=None``) makes exactly the
    same rng draws as before, so existing seeded traces replay
    unchanged."""

    def __init__(self, rate_per_s: float, vocab_size: int, *,
                 prompt_len=8, max_new_tokens: int = 16,
                 seed: int = 0, limit: Optional[int] = None,
                 shared_prefix_len: int = 0,
                 shared_fraction: float = 0.0,
                 length_dist: Optional[str] = None,
                 length_sigma: float = 0.75,
                 max_prompt_len: Optional[int] = None,
                 max_output_len: Optional[int] = None,
                 model_id: Optional[str] = None):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s!r}")
        if length_dist not in (None, "lognormal"):
            raise ValueError(
                f"length_dist must be None or 'lognormal', got "
                f"{length_dist!r}")
        if length_sigma <= 0:
            raise ValueError(
                f"length_sigma must be > 0, got {length_sigma!r}")
        self.rate = rate_per_s
        self.rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        self.prompt_lens = (tuple(prompt_len)
                            if isinstance(prompt_len, (tuple, list))
                            else (int(prompt_len),))
        self.max_new_tokens = max_new_tokens
        self.length_dist = length_dist
        self.length_sigma = length_sigma
        self.max_prompt_len = max_prompt_len
        self.max_output_len = max_output_len
        self.limit = limit
        self.model_id = model_id
        self.shared_fraction = shared_fraction
        self.shared_prefix = tuple(
            int(t) for t in self.rng.integers(0, vocab_size,
                                              shared_prefix_len))
        self._next_at = self._gap(0.0)
        self._emitted = 0

    def _gap(self, now_s: float) -> float:
        """Seconds until the next arrival after ``now_s`` (subclasses
        modulate the rate here)."""
        return now_s + float(self.rng.exponential(1.0 / self.rate))

    def _heavy_len(self, median: int, cap: Optional[int]) -> int:
        """One lognormal draw with the given median (exp(mu) = median),
        at least 1, clamped to ``cap`` when set."""
        n = int(round(median * float(
            np.exp(self.length_sigma * self.rng.standard_normal()))))
        n = max(1, n)
        return min(n, cap) if cap is not None else n

    def _prompt(self) -> Tuple[int, ...]:
        n = int(self.rng.choice(self.prompt_lens))
        if self.length_dist:
            n = self._heavy_len(n, self.max_prompt_len)
        if (self.shared_prefix
                and self.rng.random() < self.shared_fraction):
            # the drawn length is honored: short shared arrivals are a
            # truncation of the system prompt (the repeated-short-query
            # shape), long ones append a random user tail
            if n <= len(self.shared_prefix):
                return self.shared_prefix[:max(n, 1)]
            tail = n - len(self.shared_prefix)
            return self.shared_prefix + tuple(int(t) for t in
                                              self.rng.integers(
                                                  0, self.vocab_size, tail))
        return tuple(int(t) for t in self.rng.integers(
            0, self.vocab_size, n))

    def due(self, now_s: float) -> List[Arrival]:
        """All arrivals with at_s <= now_s that were not yet emitted."""
        out: List[Arrival] = []
        while self._next_at <= now_s and (
                self.limit is None or self._emitted < self.limit):
            prompt = self._prompt()        # drawn before the output len
            mnt = (self._heavy_len(self.max_new_tokens,
                                   self.max_output_len)
                   if self.length_dist else self.max_new_tokens)
            out.append(Arrival(self._next_at, prompt, mnt,
                               model_id=self.model_id))
            self._emitted += 1
            self._next_at = self._gap(self._next_at)
        return out

    @property
    def exhausted(self) -> bool:
        return self.limit is not None and self._emitted >= self.limit

    @property
    def next_at(self) -> Optional[float]:
        """Arrival time of the next pending request (None if exhausted)."""
        return None if self.exhausted else self._next_at


class DiurnalTraffic(PoissonTraffic):
    """Nonhomogeneous Poisson arrivals with a sinusoidal daily cycle.

    rate(t) = base · (1 + amplitude · sin(2πt / period_s + phase)) — the
    long diurnal trace chaos campaigns run against, so fault processes
    land on peaks and troughs rather than one constant load.  Sampled by
    thinning against the peak rate: candidate gaps are drawn at
    base·(1+amplitude) and accepted with probability rate(t)/peak, which
    keeps the arrival stream an exact seeded function of the clock.
    """

    def __init__(self, base_rate_per_s: float, vocab_size: int, *,
                 amplitude: float = 0.5, period_s: float = 60.0,
                 phase: float = 0.0, **kw):
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1), got {amplitude!r}")
        self.base_rate = base_rate_per_s
        self.amplitude = amplitude
        self.period_s = period_s
        self.phase = phase
        super().__init__(base_rate_per_s, vocab_size, **kw)

    def rate_at(self, t_s: float) -> float:
        return self.base_rate * (1.0 + self.amplitude * float(
            np.sin(2.0 * np.pi * t_s / self.period_s + self.phase)))

    def _gap(self, now_s: float) -> float:
        peak = self.base_rate * (1.0 + self.amplitude)
        t = now_s
        while True:                      # Lewis–Shedler thinning
            t += float(self.rng.exponential(1.0 / peak))
            if self.rng.random() <= self.rate_at(t) / peak:
                return t


class MixedTraffic:
    """Merge several arrival sources into one stream (multi-model
    fleets: each model's traffic keeps its own seed/rate/shape, the
    router sees one time-ordered arrival sequence)."""

    def __init__(self, sources: Sequence):
        if not sources:
            raise ValueError("MixedTraffic needs at least one source")
        self.sources = list(sources)

    def due(self, now_s: float) -> List[Arrival]:
        out: List[Arrival] = []
        for src in self.sources:
            out.extend(src.due(now_s))
        return sorted(out, key=lambda a: a.at_s)

    @property
    def exhausted(self) -> bool:
        return all(s.exhausted for s in self.sources)

    @property
    def next_at(self) -> Optional[float]:
        nxt = [s.next_at for s in self.sources if s.next_at is not None]
        return min(nxt) if nxt else None


class TraceTraffic:
    """Replay an explicit arrival trace (deterministic tests/benchmarks)."""

    def __init__(self, arrivals: Sequence[Arrival]):
        self._pending = sorted(arrivals, key=lambda a: a.at_s)

    def due(self, now_s: float) -> List[Arrival]:
        out = []
        while self._pending and self._pending[0].at_s <= now_s:
            out.append(self._pending.pop(0))
        return out

    @property
    def exhausted(self) -> bool:
        return not self._pending

    @property
    def next_at(self):
        return self._pending[0].at_s if self._pending else None
