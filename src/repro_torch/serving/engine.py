"""Batched serving engine with dense cache lanes; torch port of
``repro.serving.engine``.

``num_slots`` sequence slots share one batched decode cache (batch =
slot axis): the model's per-layer KV caches, for the SSM family its
per-layer {"ssd", "conv"} state, whose SSD state stays float32, both
kinds for the hybrid, and for the encoder-decoder {"self": KV caches,
"cross": the cross-attention K/V}, built at construction from a zero
encoder output outside any integer context, as the JAX engine builds
them. Requests
are admitted into free slots, their prompts consumed by ONE batched
prefill step per admission cohort (prompt length padded to a
power-of-two bucket), then all slots advance together by one decode step
per token. Every step runs all ``num_slots`` rows, the idle ones
included, and masks only the cache merge, as the JAX engine does: the
dynamic activation scale of an integer projection spans the whole step,
so the rows it sees must match.

Slot isolation: each step merges caches through ``model.merge_caches``
with an ``active`` mask, so a request's greedy tokens do not depend on
what shares the batch. Sampling is greedy, or temperature through a
per-request numpy generator seeded by (engine seed, uid).

Calibration (``calibrate``) freezes static activation ranges into the
quantized params. A ``CensusWatch`` reads every named site's overflow
census window by window and degrades a site past its threshold to
``wide`` (or a wider register), and undegrades it after clean windows
when asked. An ``IntegerLinConfig.certificate`` is verified against the
served weights at construction; the sites it covers run census-free.

Not ported yet, and refused at construction: paged caches, meshes, the
token-by-token prefill mode and failure injection. Snapshot/restore and
remesh are not ported either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dispatch
from repro_torch.core.tree import tree_map
from repro_torch.models.model import Model, cast_for_compute

logger = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass(frozen=True)
class CensusWatch:
    """Census-triggered graceful degradation knobs.

    Every ``window`` decode steps the engine reads the per-site overflow
    census rates since the last check. A site whose event / dot ratio
    exceeds ``threshold`` (over at least ``min_dots`` dots) is swapped:
    ``mode="wide"`` flips its policy to the overflow-free ``wide``,
    ``mode="widen"`` raises its ``acc_bits`` to ``widen_to``. The rest
    of the model keeps its narrow policies; a structured event goes to
    ``engine.events`` and ``stats["census_degrades"]`` counts it.

    Degradation is monotone unless ``undegrade_after=N``: a degraded
    site whose census stays clean (rate <= threshold over >= min_dots
    dots) for N consecutive windows drops its overrides
    (``census_undegrade`` event, ``stats["census_undegrades"]``). A dirty
    window resets the streak; a window under ``min_dots`` dots neither
    advances nor resets it.
    """

    threshold: float = 0.01
    window: int = 8
    mode: str = "wide"  # "wide" (policy swap) | "widen" (acc_bits raise)
    widen_to: int = 30
    min_dots: int = 1
    undegrade_after: Optional[int] = None  # N clean windows to re-narrow


class ServingEngine:
    def __init__(
        self,
        model: Model,
        params: Any,
        num_slots: int = 8,
        max_len: int = 512,
        cache_dtype=torch.float32,
        seed: int = 0,
        int_lin: Optional[dispatch.IntegerLinConfig] = None,
        prefill_decode_ratio: int = 0,
        device=None,
        prefill_mode: str = "batched",
        page_size: Optional[int] = None,
        mesh=None,
        census_watch=None,
        failure_injector=None,
    ):
        if prefill_mode != "batched":
            raise NotImplementedError(
                "only prefill_mode='batched' is ported")
        if page_size is not None or mesh is not None or \
                failure_injector is not None:
            raise NotImplementedError(
                "paged caches, meshes and failure injection are not "
                "ported yet")
        if census_watch is not None and int_lin is None:
            raise ValueError(
                "census_watch monitors integer projections; it needs "
                "int_lin= (float engines have no overflow census)")
        if int_lin is not None and int_lin.certificate is not None:
            # a certificate proves accumulator safety only for the integer
            # weights it hashed: refuse a census-free path for any other
            # (core.certify.CertificateError)
            int_lin.certificate.verify(params)
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"the model's {model.device}")
        self.model = model
        # the float leaves in the compute dtype once: the model's cast on
        # every step then finds them cast and launches nothing
        self.params = cast_for_compute(params, model.cfg)
        self.num_slots = num_slots
        self.max_len = max_len
        self.int_lin = int_lin
        self.prefill_decode_ratio = prefill_decode_ratio
        self._seed = seed
        self.caches = model.init_caches(params, num_slots, max_len,
                                        cache_dtype)
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.queue: list[Request] = []
        self._pending: list[tuple[int, Request]] = []  # admitted, unfilled
        self._ready = np.zeros(num_slots, bool)  # prefilled, decoding
        self._pos = np.zeros(num_slots, np.int64)
        self._next_token = np.zeros((num_slots, 1), np.int32)
        self._budget = np.zeros(num_slots, np.int64)
        self._since_prefill = 0
        self._step_idx = 0
        self.stats = {
            "prefill_steps": 0,
            "decode_steps": 0,
            "cohorts": 0,
            "queue_wait_steps": 0,
            "census_degrades": 0,
            "census_undegrades": 0,
        }
        self.events: list[dict] = []  # structured log (census degrades)
        # census-triggered degradation: one monitor for the engine's
        # lifetime, drained a window at a time
        self.census_watch = census_watch
        self._census = (dispatch.CensusMonitor()
                        if census_watch is not None else None)
        self._census_steps = 0
        self._degraded: set[str] = set()
        # consecutive clean windows per degraded site (the undegrade)
        self._clean_windows: dict[str, int] = {}
        self.last_census_rates: dict[str, float] = {}

    # -- step functions ------------------------------------------------------

    def _int_ctx(self):
        stack = contextlib.ExitStack()
        if self.int_lin is not None:
            stack.enter_context(dispatch.integer_lin(self.int_lin))
        if self._census is not None:
            stack.enter_context(dispatch.census_monitor(self._census))
        return stack

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    @torch.no_grad()
    def _step(self, tok: np.ndarray, active: np.ndarray):
        with self._int_ctx():
            logits, new = self.model.decode(self.params, self._tensor(tok),
                                            self.caches)
        self.caches = self.model.merge_caches(self.caches, new,
                                              self._tensor(active))
        return logits

    @torch.no_grad()
    def _prefill_step(self, toks: np.ndarray, lengths: np.ndarray,
                      active: np.ndarray) -> None:
        with self._int_ctx():
            _, new = self.model.prefill(self.params, self._tensor(toks),
                                        self.caches, self._tensor(lengths))
        # each leaf back to its cache dtype (a bfloat16 conv ring fed
        # float32 activations), the whole tree walked as the JAX engine's
        # tree_map does
        new = tree_map(lambda o, n: n.to(o.dtype), self.caches, new)
        self.caches = self.model.merge_caches(self.caches, new,
                                              self._tensor(active))

    def _reset(self, mask: np.ndarray) -> None:
        """Zero the ``mask`` slots of every cache leaf (the
        encoder-decoder's cross K/V included, as in the JAX engine)."""
        zeros = tree_map(torch.zeros_like, self.caches)
        self.caches = self.model.merge_caches(self.caches, zeros,
                                              self._tensor(mask))

    # -- calibration ---------------------------------------------------------

    @torch.no_grad()
    def calibrate(self, batches: list[Any], act_bits: int = 8,
                  symmetric: bool = True, decay: float = 0.9) -> dict:
        """Calibrate, then freeze static activation ranges for integer
        decode: run ``model.forward`` over ``batches`` (batch dicts with
        ``tokens``) on the float dequantized path with the range observer
        active, freeze the bias-corrected per-site bounds into static
        QParams and attach them to this engine's quantized params. Later
        steps quantize activations with the frozen scales. Returns the
        frozen site -> QParams dict."""
        from repro_torch.core.qtensor import attach_act_qparams
        from repro_torch.core.quant import ActCalibrator

        cal = ActCalibrator(decay=decay)
        with dispatch.calibration(cal):
            for batch in batches:
                self.model.forward(self.params, {
                    k: v.to(self.device) if isinstance(v, torch.Tensor)
                    else self._tensor(np.asarray(v))
                    for k, v in batch.items()})
        frozen = cal.freeze(bits=act_bits, symmetric=symmetric)
        self.params = attach_act_qparams(self.params, frozen)
        return frozen

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) = {total} exceeds "
                f"max_len={self.max_len}")
        req.t_submit = time.perf_counter()
        req._submit_step = self._step_idx
        # per-request sampling stream: reproducible under any batch
        # composition or admission order
        req._rng = np.random.default_rng((self._seed, req.uid))
        self.queue.append(req)

    def _admit(self) -> None:
        """Claim free slots from the queue, clear their cache lanes, and
        hand the cohort to ``_maybe_prefill``."""
        free = [i for i in range(self.num_slots) if self.slots[i] is None]
        admitted: list[tuple[int, Request]] = []
        while free and self.queue:
            req = self.queue.pop(0)
            slot = free.pop(0)
            self.slots[slot] = req
            self._ready[slot] = False
            self._pos[slot] = 0
            self.stats["queue_wait_steps"] += self._step_idx - req._submit_step
            admitted.append((slot, req))
        if not admitted:
            return
        mask = np.zeros(self.num_slots, bool)
        for slot, _ in admitted:
            mask[slot] = True
        self._reset(mask)
        self._pending.extend(admitted)
        self._maybe_prefill()

    def _maybe_prefill(self) -> None:
        """Prefill the pending cohort now, or after ``prefill_decode_ratio``
        decode steps while other slots are mid-decode."""
        if not self._pending:
            return
        have_ready = any(self.slots[i] is not None and self._ready[i]
                         for i in range(self.num_slots))
        if have_ready and self._since_prefill < self.prefill_decode_ratio:
            return
        cohort, self._pending = self._pending, []
        self._prefill(cohort)
        self._since_prefill = 0
        for slot, req in cohort:
            self._pos[slot] = len(req.prompt) - 1
            self._ready[slot] = True

    def _prefill(self, admitted: list[tuple[int, Request]]) -> None:
        """Consume the admitted prompts; the final prompt token is held
        back for the first decode step, which samples the first token."""
        self.stats["cohorts"] += 1
        self._prefill_batched(admitted)
        for slot, req in admitted:
            self._next_token[slot, 0] = int(req.prompt[-1])
            self._budget[slot] = req.max_new_tokens

    def _prefill_batched(self, admitted: list[tuple[int, Request]]) -> None:
        """ONE batched prefill step for the cohort: prompts left-aligned in
        a (num_slots, S) buffer, S a power-of-two bucket; other slots
        carry length 0 and are masked out of the merge."""
        longest = max(len(req.prompt) for _, req in admitted) - 1
        if longest <= 0:
            return  # single-token prompts: nothing to prefill
        s = 1 << (longest - 1).bit_length()
        toks = np.zeros((self.num_slots, s), np.int32)
        lengths = np.zeros(self.num_slots, np.int32)
        active = np.zeros(self.num_slots, bool)
        for slot, req in admitted:
            n = len(req.prompt) - 1
            toks[slot, :n] = req.prompt[:-1]
            lengths[slot] = n
            active[slot] = True
        self._prefill_step(toks, lengths, active)
        self.stats["prefill_steps"] += 1

    # -- decode loop ---------------------------------------------------------

    def _sample(self, logits: np.ndarray, slot: int) -> int:
        req = self.slots[slot]
        row = logits[slot, -1]
        if req.temperature <= 0:
            return int(row.argmax())
        z = row / req.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        rng = getattr(req, "_rng", None)
        if rng is None:  # request bypassed submit(); still per-request
            rng = req._rng = np.random.default_rng((self._seed, req.uid))
        return int(rng.choice(len(p), p=p))

    def step(self) -> int:
        """One batched decode step (plus admission/prefill bookkeeping).
        Returns the slots that decoded plus the pending prefills; 0 means
        the engine is idle."""
        self._step_idx += 1
        self._admit()
        self._maybe_prefill()
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and self._ready[i]]
        if not active:
            return len(self._pending)
        mask = np.zeros(self.num_slots, bool)
        mask[active] = True
        logits = self._step(self._next_token, mask)
        self.stats["decode_steps"] += 1
        self._since_prefill += 1
        logits = logits.to(torch.float32).cpu().numpy()
        for slot in active:
            req = self.slots[slot]
            nxt = self._sample(logits, slot)
            req.output.append(nxt)
            self._next_token[slot, 0] = nxt
            self._pos[slot] += 1
            self._budget[slot] -= 1
            if self._budget[slot] <= 0 or (
                req.eos_id is not None and nxt == req.eos_id
            ):
                req.done = True
                req.t_done = time.perf_counter()
                self.slots[slot] = None
                self._ready[slot] = False
        if self.census_watch is not None:
            self._check_census()
        return len(active) + len(self._pending)

    def drain(self, requests: list[Request], max_steps: int = 100_000) -> None:
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break

    # -- census-triggered graceful degradation --------------------------------

    def _check_census(self) -> None:
        """Window check: swap any site saturating its accumulator.

        Every ``window`` decode steps, drain the per-site census (one host
        copy for the window). A degraded site first gets its undegrade
        pass (``undegrade_after``), then every site over the threshold
        degrades once: its policy flips to ``wide`` or its ``acc_bits``
        widens, through ``self.int_lin``, which the next step's context
        reads. A ``wide`` site keeps reporting dots with zero events, so
        the next window reads rate 0.0. A certified site never appears:
        ``dispatch.qtensor_dot`` runs it census-free.
        """
        self._census_steps += 1
        if self._census_steps < self.census_watch.window:
            return
        self._census_steps = 0
        watch = self.census_watch
        totals = self._census.drain()
        self.last_census_rates = {
            s: (e / d if d else 0.0) for s, (d, e) in totals.items()}
        # reverse transition first: a site clean for N consecutive
        # windows drops its overrides and re-narrows
        if watch.undegrade_after is not None:
            for site in sorted(self._degraded):
                dots, events = totals.get(site, (0, 0))
                if dots < watch.min_dots:
                    continue  # no evidence either way: freeze the streak
                rate = events / dots
                if rate > watch.threshold:
                    self._clean_windows[site] = 0
                    continue
                streak = self._clean_windows.get(site, 0) + 1
                self._clean_windows[site] = streak
                if streak < watch.undegrade_after:
                    continue
                self.int_lin = self.int_lin.without_site(site)
                self._degraded.discard(site)
                self._clean_windows.pop(site, None)
                self.stats["census_undegrades"] += 1
                self.events.append({
                    "event": "census_undegrade", "site": site,
                    "clean_windows": streak, "rate": rate, "dots": dots,
                    "step": self._step_idx})
                logger.info(
                    "census_undegrade site=%s after %d clean windows "
                    "(rate=%.4f over %d dots) at step %d",
                    site, streak, rate, dots, self._step_idx)
        for site, (dots, events) in sorted(totals.items()):
            if dots < watch.min_dots or site in self._degraded:
                continue
            rate = events / dots
            if rate <= watch.threshold:
                continue
            if watch.mode == "widen":
                self.int_lin = self.int_lin.with_site_acc_bits(
                    site, watch.widen_to)
                action = {"acc_bits": watch.widen_to}
            else:
                self.int_lin = self.int_lin.with_site_policy(site, "wide")
                action = {"policy": "wide"}
            self._degraded.add(site)
            self.stats["census_degrades"] += 1
            self.events.append({
                "event": "census_degrade", "site": site, "rate": rate,
                "dots": dots, "overflows": events, "step": self._step_idx,
                **action})
            logger.warning(
                "census_degrade site=%s rate=%.4f (%d/%d dots) -> %s at "
                "step %d", site, rate, events, dots, action, self._step_idx)
