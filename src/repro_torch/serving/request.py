"""Request / sequence state machine for the serving engine."""
from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    MIGRATING = "migrating"   # in flight between executors after a failure
    FAILED = "failed"


_req_counter = itertools.count(1)


@dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int
    req_id: int = field(default_factory=lambda: next(_req_counter))
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = field(default_factory=list)
    arrival_time: float = field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None   # TTFT = this - arrival_time
    finish_time: Optional[float] = None
    dp_rank: Optional[int] = None        # executor currently responsible
    batch_slot: Optional[int] = None     # slot in the executor's decode batch
    instance_id: Optional[int] = None    # fleet instance currently serving us
    model_id: Optional[str] = None       # multi-model fleets: required config
    eos_token: Optional[int] = None
    migrations: int = 0                  # how many times recovery moved us
    cross_instance_migrations: int = 0   # moved to a different fleet instance
    recomputed_tokens: int = 0           # decode work redone due to recovery
    # chunked-prefill progress: prompt positions [0, prefill_pos) have
    # their KV installed (prefix-cache hits count — they skip compute).
    # A RUNNING request only joins the decode batch once prefill_pos
    # reaches its admission-time prefill target.
    prefill_pos: int = 0
    # overlap pipeline: the last `speculative_tokens` entries of
    # `output_tokens` are plan-ahead *guesses* for a step still in
    # flight on device.  They exist so the next step can be planned at
    # the predicted positions; the values are replaced by the
    # authoritative host-sampled tokens when the step drains (or popped
    # wholesale on reconcile/rollback).  Consumers that must only see
    # committed tokens (streaming, migration export) read
    # ``committed_output``.
    speculative_tokens: int = 0

    @property
    def committed_output(self) -> List[int]:
        """Output tokens confirmed by a drained step (never speculative)."""
        if self.speculative_tokens:
            return self.output_tokens[:len(self.output_tokens)
                                      - self.speculative_tokens]
        return self.output_tokens

    def apply_speculative(self, tokens: List[int]) -> None:
        self.output_tokens.extend(int(t) for t in tokens)
        self.speculative_tokens += len(tokens)

    def confirm_speculative(self, tokens: List[int]) -> None:
        """Replace this request's oldest in-flight guesses with the
        authoritative sampled values (counts already verified equal)."""
        n = len(tokens)
        base = len(self.output_tokens) - self.speculative_tokens
        self.output_tokens[base:base + n] = [int(t) for t in tokens]
        self.speculative_tokens -= n

    def unwind_speculative(self, n: int) -> None:
        if n:
            del self.output_tokens[len(self.output_tokens) - n:]
            self.speculative_tokens -= n

    @property
    def tokens_so_far(self) -> List[int]:
        return self.prompt_tokens + self.output_tokens

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def done(self) -> bool:
        if len(self.output_tokens) >= self.max_new_tokens:
            return True
        return (self.eos_token is not None and self.output_tokens
                and self.output_tokens[-1] == self.eos_token)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def note_token(self, now: Optional[float] = None) -> None:
        """Record the first-token timestamp (idempotent)."""
        if self.first_token_time is None and self.output_tokens:
            self.first_token_time = (time.monotonic()
                                     if now is None else now)

    def rebuild_prompt_for_migration(self) -> "Request":
        """§3.2 partial recomputation: prompt + decoded tokens become the
        new prompt; the new executor re-prefills but skips completed
        decoding steps (they stay in ``output_tokens`` accounting)."""
        self.state = RequestState.MIGRATING
        self.migrations += 1
        self.dp_rank = None
        self.batch_slot = None
        self.prefill_pos = 0
        return self
