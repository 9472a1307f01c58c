"""Speculative decoding: draft-engine propose, one batched verify
(counterpart of paddle_tpu/serving/spec.py).

A cheap DRAFT arm guesses the next gamma tokens of every slot, the TARGET
scores all gamma+1 positions in one verify pass, and the longest agreeing
prefix is emitted (Leviathan et al. '23; Chen et al. '23). Sampling here
is a pure function of (request seed, generated index), so rejection
sampling degenerates to exact-match verification: the verify pass
computes the token the target would emit at every candidate position
(greedy and seeded top-k) and accepts draft tokens only while they are
equal. Spec-on tokens equal spec-off tokens by construction; the draft
moves only the acceptance rate.

One round (SpecDecoder.run_round):

1. **Propose**: the draft arm (by default the int8-weight arm of the same
   checkpoint) is an unstarted DecodeEngine with window = gamma, driven
   on the target's service thread; its window is a captured graph like
   the target's.
2. **Verify**: the target's captured verify pass
   (DecodeEngine._verify_eager) writes and attends each position with the
   window's shapes and samples at generated indices gen..gen+gamma; the
   device computes each slot's accepted count.
3. **Accept / roll back**: the agreeing prefix plus the target's own
   correction or bonus token goes through the window's host walk
   (_apply_slot_tokens); blocks covering only rejected positions return
   to the slot's ordered reserve (cache.truncate_mapped), so refcounts
   never move mid-flight and a prefix chain's shared blocks are never
   touched.

Draft state rides a LAG-ONE sync: after a fully accepted round the
draft's next window re-writes the last accepted token's k/v first (its
first sample is checked against the bonus token already emitted and
dropped), so the draft cache has no holes; after a rejection the
target's correction overwrites the draft's stale positions before any
read reaches them.

A draft failure (a prefill or propose error, a `serving.spec.draft`
fault-site injection, `kill_draft`) degrades the engine to plain decode at
the next round boundary with zero failed requests. The ServingFrontend's
health loop walks the draft through live -> suspect -> dead ->
resurrecting like an engine and re-arms speculation only after the
target's canary passes with speculation armed (a valid gate because
spec-on tokens equal spec-off tokens). Replicas share one draft weight
copy (`draft_prepared`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..flags import flag
from ..models.gpt import GPTConfig
from ..models.gpt_decode import fold_seed
from ..framework.executor import _on_stream
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..resilience.faults import fault_point
from .resilience import Health


@dataclasses.dataclass
class SpecConfig:
    """Draft-arm geometry. `tokens` is gamma, the draft depth per round
    (0 = FLAGS_serving_spec_tokens). The default draft is the same
    checkpoint requantized to `draft_dtype` (int8). A separate small model
    rides `draft_params` + `draft_model_config` (its vocab must be the
    target's: proposals are candidate target tokens)."""
    tokens: int = 0
    draft_dtype: str = "int8"
    draft_params: Optional[Dict] = None
    draft_model_config: Optional[GPTConfig] = None

    def resolve(self) -> "SpecConfig":
        c = dataclasses.replace(self)
        if not c.tokens:
            c.tokens = int(flag("FLAGS_serving_spec_tokens"))
        if not 1 <= c.tokens <= 16:
            raise ValueError(
                f"spec tokens (gamma) must be in [1, 16], got {c.tokens}")
        if c.draft_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"draft_dtype must be float32|bfloat16|int8, "
                f"got {c.draft_dtype!r}")
        if (c.draft_params is None) != (c.draft_model_config is None):
            raise ValueError(
                "draft_params and draft_model_config come together: a "
                "separate draft model needs its own config, and a config "
                "without weights is not a draft")
        return c


class _DraftSlot:
    """Draft-side mirror of one target slot. `token` is the committed token
    whose k/v the next draft window writes first, at `pos`; `pending`
    (lag-one sync) is the following committed token, already emitted by
    the target: the draft window's first sample is checked against it and
    dropped."""
    __slots__ = ("token", "pos", "pending")

    def __init__(self, token: int, pos: int,
                 pending: Optional[int] = None):
        self.token = token
        self.pos = pos
        self.pending = pending


class SpecDecoder:
    """The speculation driver a DecodeEngine owns (engine.spec). Everything
    runs on the target's service thread between windows, except
    `kill_draft`, which posts a flag honored at the next round."""

    def __init__(self, engine, config: SpecConfig,
                 raw_params: Optional[Dict] = None,
                 _draft_prepared: Optional[tuple] = None):
        self.engine = engine
        self.config = config
        self.health = Health.LIVE
        self.health_history: List[str] = [Health.LIVE]
        self._kill: Optional[str] = None
        self._dead_reason: Optional[str] = None
        self._rounds = 0
        self._proposed = 0
        self._accepted = 0
        self._rejected = 0
        self._degraded = 0
        mc = config.draft_model_config or engine.model_config
        if mc.vocab_size != engine.model_config.vocab_size:
            raise ValueError(
                f"draft vocab {mc.vocab_size} != target vocab "
                f"{engine.model_config.vocab_size}: draft proposals are "
                "candidate target tokens")
        if (config.draft_params is None and raw_params is None
                and _draft_prepared is None):
            raise ValueError("no draft weights: the default same-checkpoint "
                             "draft needs the raw params (or a prepared "
                             "clone source)")
        self.draft = self._build_draft(mc, raw_params, _draft_prepared)
        _metrics.set_gauge("serving.spec.armed", 1)

    def _build_draft(self, mc: GPTConfig, raw_params, _draft_prepared):
        """The draft arm: an unstarted DecodeEngine with the target's
        geometry (mirror slots map 1:1), window = gamma, no prefix cache,
        float KV pools, no spec of its own. run_round drives its prefill
        and captured window directly, on the target's service thread and
        stream."""
        from .engine import DecodeEngine, EngineConfig
        t = self.engine.config
        dcfg = EngineConfig(
            max_slots=t.max_slots, block_size=t.block_size,
            num_blocks=t.num_blocks, max_len=t.max_len,
            window=self.config.tokens, dtype=self.config.draft_dtype,
            max_queue=t.max_queue, kv_dtype="", prefix_cache=False,
            spec=None, requested_max_len=t.requested_max_len)
        params = (self.config.draft_params
                  if self.config.draft_params is not None else raw_params)
        return DecodeEngine(params, mc, config=dcfg,
                            device=self.engine.device,
                            _prepared=_draft_prepared)

    @property
    def draft_prepared(self) -> tuple:
        """The draft's prepared weight tensors, for frontend._clone_engine:
        replicas adopt one draft weight copy as they adopt one target
        copy."""
        return (self.draft.params, self.draft.scales,
                self.draft.compute_dtype)

    @property
    def armed(self) -> bool:
        """Whether the service loop runs speculative rounds. A posted kill
        stays armed until run_round honors it, so the degrade is counted
        once."""
        return self.health == Health.LIVE

    # ------------------------------------------------------------------
    # health
    # ------------------------------------------------------------------
    def _set_health(self, state: str):
        if state != self.health:
            self.health = state
            self.health_history.append(state)
            del self.health_history[:-64]
            _trace.instant("serving.spec.health",
                           args={"engine": self.engine._id,
                                 "state": state})

    def _degrade(self, why: str):
        """Draft failure -> plain decode. SUSPECT when a frontend watches
        (its health tick confirms DEAD and later resurrects); straight to
        DEAD standalone. Mirror slots are dropped (host bookkeeping only);
        `resurrect_draft` resets the pool."""
        self._dead_reason = why
        self._degraded += 1
        _metrics.inc("serving.spec.degraded")
        _metrics.set_gauge("serving.spec.armed", 0)
        _trace.instant("serving.spec.degraded",
                       args={"engine": self.engine._id, "why": why})
        self._set_health(Health.SUSPECT
                         if self.engine._failover is not None
                         else Health.DEAD)
        try:
            self.release_all()
        except Exception:   # noqa: BLE001 — a torn draft allocator must
            # not take the TARGET engine down; the rebuild replaces it
            self.draft._slots.clear()

    def kill_draft(self, why: str):
        """Kill the draft arm from any thread. Honored at the next round
        boundary, so it never races a draft call's slot accounting."""
        self._kill = why

    def resurrect_draft(self):
        """Reset the draft arm's pool in place and clear the kill; `rearm`
        then makes speculation live again. As for the target engine
        (DecodeEngine.resurrect), the pools and static buffers are zeroed
        at their addresses on the target's stream, and the draft's
        captured graph is kept: nothing is captured while the target
        serves."""
        self._set_health(Health.RESURRECTING)
        _metrics.inc("serving.spec.resurrections")
        d, eng = self.draft, self.engine
        d._slots.clear()
        with _on_stream(eng.device, eng._stream):
            d.cache.reset()
            for t in d._static.values():
                t.zero_()
        self._kill = None
        self._dead_reason = None

    def rearm(self):
        """LIVE again (after `resurrect_draft`; also the provisional arm
        that lets the frontend's canary decode through speculation). Slots
        admitted while the draft was dead have no mirror and verify with
        no proposals."""
        self._set_health(Health.LIVE)
        _metrics.set_gauge("serving.spec.armed", 1)

    def reset(self):
        """engine.resurrect(): reset the draft with the target and re-arm;
        the frontend's canary then checks the whole spec-on path."""
        self.resurrect_draft()
        self.rearm()

    def close(self):
        self.draft.cache.close()

    # ------------------------------------------------------------------
    # slot lifecycle (called by the target engine)
    # ------------------------------------------------------------------
    def on_admit(self, slot_idx: int, req, plen: int, first_token: int):
        """Fund + prefill the draft mirror of a freshly admitted slot. Its
        first sampled token is dropped: the TARGET's first token seeds the
        mirror. A failure degrades; an unfundable draft pool leaves the
        slot uncovered (no proposals, still the same tokens)."""
        if not self.armed or self._kill is not None:
            return
        d = self.draft
        try:
            blocks = d.cache.assign(
                slot_idx, d._block_budget(plen, req.max_new_tokens))
            if blocks is None:
                _metrics.inc("serving.spec.draft_unfunded")
                return
            d._cold_prefill(req, plen, blocks)
            d._slots[slot_idx] = _DraftSlot(first_token, plen)
        except Exception as e:   # noqa: BLE001 — degrade, never fail
            if d.cache.blocks_of(slot_idx):
                d.cache.release(slot_idx)
            self._degrade(f"draft prefill failed: {e!r}")

    def on_release(self, slot_idx: int):
        d = self.draft
        if d._slots.pop(slot_idx, None) is not None:
            d.cache.release(slot_idx)

    def release_all(self):
        for idx in list(self.draft._slots):
            self.on_release(idx)

    # ------------------------------------------------------------------
    # the speculative round
    # ------------------------------------------------------------------
    def _propose(self) -> Dict[int, List[int]]:
        """One draft window (gamma steps) over the mirror slots; returns
        the usable proposals per slot. A mirror lagging one position
        (pending set) spends its first sample on the lag-one check; a
        mismatch there yields no proposals this round."""
        fault_point("serving.spec.draft")
        eng, d = self.engine, self.draft
        gamma = self.config.tokens
        host = d._slot_arrays(slots={})     # the draft's page table
        covered = []
        for i, ds in d._slots.items():
            t = eng._slots.get(i)
            if t is None:
                continue
            gap = t.pos - ds.pos                # 0, or 1 when pending
            host["tokens"][i], host["pos"][i] = ds.token, ds.pos
            # draft samples ride the TARGET's (seed, index) schedule, so
            # an agreeing draft token IS the target's token
            host["gen"][i] = t.gen - gap
            host["live"][i] = True
            host["temps"][i], host["top_ks"][i] = t.temp, t.top_k
            host["seeds"][i] = fold_seed(t.seed)
            host["eos"][i] = -1                 # never latch mid-window
            host["max_new"][i] = host["gen"][i] + gamma + 1
            covered.append(i)
        if not covered:
            return {}
        with _trace.RecordEvent("serving.spec_draft",
                                args={"engine": eng._id,
                                      "active": len(covered)}):
            toks, _ = d._window_tokens(host)
        props: Dict[int, List[int]] = {}
        for i in covered:
            chain = [int(toks[s, i]) for s in range(gamma)]
            ds = d._slots[i]
            if ds.pending is not None:
                if chain[0] != ds.pending:
                    props[i] = []   # mis-rewrote the pending position;
                    continue        # the post-round sync re-aims it
                chain = chain[1:]
            props[i] = chain
        return props

    def run_round(self):
        """One speculative round: propose -> verify -> emit the agreeing
        prefix + correction -> roll rejected blocks back into the reserve
        -> lag-one draft sync. Every fallback keeps the tokens spec-off
        gives; only the tokens per call vary."""
        eng = self.engine
        if self._kill is not None:
            why, self._kill = self._kill, None
            self._degrade(f"draft killed: {why}")
            eng._run_window()
            return
        gamma = self.config.tokens
        span = gamma + 1
        B = eng.config.max_slots
        bs = eng.config.block_size
        try:
            props = self._propose()
        except Exception as e:   # noqa: BLE001 — draft faults degrade;
            # target faults (inside _run_verify below) still escalate
            self._degrade(f"draft propose failed: {e!r}")
            eng._run_window()
            return
        if not props:
            # no mirror at all (every live slot admitted while degraded):
            # a plain window emits more tokens per call
            eng._run_window()
            return
        cand = np.zeros((B, span), np.int64)
        valid = np.zeros((B, span), bool)
        g_eff: Dict[int, int] = {}
        before: Dict[int, int] = {}             # slot.token pre-apply
        for idx, slot in list(eng._slots.items()):
            cand[idx, 0] = slot.token
            valid[idx, 0] = True
            p = props.get(idx, [])
            g = max(0, min(gamma, slot.max_new - slot.gen - 1, len(p)))
            cand[idx, 1:1 + g] = p[:g]
            valid[idx, 1:1 + g] = True
            g_eff[idx] = g
            before[idx] = slot.token
            # map reserve blocks up to the furthest real write this round
            # (invalid positions land on the scratch block)
            eng.cache.extend_mapped(idx, (slot.pos + g) // bs + 1)
        vtok, n_acc = eng._run_verify(cand, valid)
        self._rounds += 1
        _metrics.inc("serving.spec.rounds")
        n_tokens = 0
        for idx in list(eng._slots):
            slot = eng._slots.get(idx)
            if slot is None:
                continue
            g = g_eff.get(idx, 0)
            a = min(int(n_acc[idx]), g)
            self._proposed += g
            self._accepted += a
            self._rejected += g - a
            _metrics.inc("serving.spec.proposed", g)
            _metrics.inc("serving.spec.accepted", a)
            _metrics.inc("serving.spec.rejected", g - a)
            n, finished = eng._apply_slot_tokens(
                idx, slot, [int(vtok[idx, j]) for j in range(a + 1)])
            n_tokens += n
            if finished is not None:
                continue        # released (on_release dropped the mirror)
            # rollback: keep only the blocks covering committed positions
            # 0..pos-1 (shared prefix blocks lie below pos > prompt_len)
            eng.cache.truncate_mapped(idx, (slot.pos - 1) // bs + 1)
            ds = self.draft._slots.get(idx)
            if ds is None:
                continue
            p = props.get(idx, [])
            if a < g:
                # the correction overwrote the draft's stale tail before
                # any read reaches it: the mirror rejoins the target
                ds.token, ds.pos, ds.pending = slot.token, slot.pos, None
            else:
                # fully accepted (or nothing verified): the last committed
                # token's k/v is not in the draft cache yet — lag one
                ds.token = before[idx] if a == 0 else p[a - 1]
                ds.pos = slot.pos - 1
                ds.pending = slot.token
        _metrics.inc("serving.tokens_out", n_tokens)
        _metrics.set_gauge("serving.active_slots", len(eng._slots))
        if self._proposed:
            _metrics.set_gauge("serving.spec.accept_rate",
                               self._accepted / self._proposed)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "spec_decode": True,
            "spec_armed": self.armed,
            "spec_gamma": self.config.tokens,
            "spec_draft_health": self.health,
            "spec_rounds": self._rounds,
            "spec_proposed": self._proposed,
            "spec_accepted": self._accepted,
            "spec_rejected": self._rejected,
            "spec_accept_rate": (self._accepted / self._proposed
                                 if self._proposed else 0.0),
            "spec_degraded": self._degraded,
            "spec_draft_free_blocks":
                self.draft.cache.allocator.free_blocks,
        }
