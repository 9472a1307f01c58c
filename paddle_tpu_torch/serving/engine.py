"""Continuous-batching decode engine over the paged KV cache (counterpart of
paddle_tpu/serving/engine.py).

Iteration-level scheduling (Orca, OSDI '22): the engine owns a FIXED slot
array of width `max_slots` and decodes in `window`-token windows. Between
windows (and only between windows) the service thread retires finished
slots and admits queued requests, so batch composition churns freely while
every window runs the same shapes.

Each admitted request is prefilled once (a dense causal forward over its
prompt padded to a block-aligned bucket), its prompt k/v is scattered into
the blocks its slot was funded with, and the slot joins the next window.
Every window step runs the SAME transformer block body as
models/gpt_decode (`_block`) with a merge hook that writes the new position
into the pools in place and attends through `ops.paged_ops.fused_attend`:
the hand-written CUDA kernel on the card, its plain PyTorch version on CPU
tensors. There is no switch between the two: the tensors' device decides.

Sampling is per slot and a pure function of (request seed, generated
index), so a request's tokens do not depend on which slot or window
carries it: continuous batching gives the tokens one-at-a-time decoding
gives (`generate_sequential`).

Not ported yet (EngineConfig refuses them with NotImplementedError): the
radix prefix cache, speculative decoding, int8 weights and the
FLAGS_step_deadline_ms window watchdog. Replica failover, drain and kill
(serving/resilience.py of the reference) are not ported either.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..flags import flag
from ..framework.errors import UnimplementedError
from ..models.gpt import GPTConfig
from ..models.gpt_decode import _block, _embed, _ln, _logits, _sample
from ..observability import metrics as _metrics
from ..ops.paged_ops import fused_attend, paged_update, quantize_kv
from .cache import CacheConfig, PagedKVCache
from .request import Completion, Request, RequestHandle, RequestState
from .resilience import Health, shed_handle
from .weights import prepare_params

_engine_ids = itertools.count(1)


@dataclasses.dataclass
class EngineConfig:
    """Serving geometry. Every field is fixed for the engine's lifetime.
    0 means "take the flag default" (FLAGS_serving_window /
    FLAGS_serving_block_size / FLAGS_serving_max_queue)."""
    max_slots: int = 4
    block_size: int = 0
    num_blocks: int = 64
    max_len: int = 128          # per-request prompt + generation budget
    window: int = 0
    dtype: str = "float32"      # "float32" | "bfloat16" ("int8": not yet)
    max_queue: int = 0          # submit-queue bound (admission control)
    kv_dtype: str = ""          # "" = compute dtype; "int8" = quantized
                                # KV pools (abs-max grid, static kv_scale)
    kv_scale: float = 8.0       # int8-KV abs-max clip range
    prefix_cache: bool = False  # radix prefix cache: not ported yet
    spec: Optional[object] = None   # speculative decoding: not ported yet

    def resolve(self) -> "EngineConfig":
        c = dataclasses.replace(self)
        if c.prefix_cache:
            raise UnimplementedError("prefix_cache is not ported yet")
        if c.spec not in (None, False):
            raise UnimplementedError("speculative decoding (spec) is not "
                                     "ported yet")
        if c.dtype == "int8":
            raise UnimplementedError("int8 serving weights are not ported "
                                     "yet")
        if float(flag("FLAGS_step_deadline_ms") or 0.0) > 0:
            raise UnimplementedError("FLAGS_step_deadline_ms (the window "
                                     "watchdog) is not ported yet")
        c.spec = None
        if not c.block_size:
            c.block_size = int(flag("FLAGS_serving_block_size"))
        if not c.window:
            c.window = int(flag("FLAGS_serving_window"))
        if not c.max_queue:
            c.max_queue = int(flag("FLAGS_serving_max_queue"))
        if c.max_len % c.block_size:
            c.max_len += c.block_size - c.max_len % c.block_size
        if c.kv_dtype not in ("", "int8"):
            raise ValueError(f"kv_dtype must be '' or 'int8', "
                             f"got {c.kv_dtype!r}")
        return c


class _Slot:
    __slots__ = ("handle", "pos", "gen", "token", "eos", "max_new",
                 "temp", "top_k", "seed")

    def __init__(self, handle, pos, gen, token, eos, max_new, temp,
                 top_k, seed):
        self.handle = handle
        self.pos = pos
        self.gen = gen
        self.token = token
        self.eos = eos
        self.max_new = max_new
        self.temp = temp
        self.top_k = top_k
        self.seed = seed


class DecodeEngine:
    """One decode worker: a slot array, a paged cache on `device` (default
    cuda), and the service thread interleaving admission with decode
    windows."""

    def __init__(self, params: Dict, model_config: GPTConfig,
                 config: Optional[EngineConfig] = None,
                 device: DeviceLike = None, **overrides):
        self.device = resolve_device(device)
        self.model_config = model_config
        if config is not None and overrides:
            raise ValueError("pass EngineConfig or overrides, not both")
        raw = config or EngineConfig(**overrides)
        # guard on the REQUESTED budget; resolve() then rounds max_len up
        # to a block multiple, which only widens the (masked) cache view
        if raw.max_len > model_config.max_position:
            raise ValueError(
                f"max_len {raw.max_len} exceeds model max_position "
                f"{model_config.max_position}")
        cfg = raw.resolve()
        self.config = cfg
        # per-request prompt+generation ceiling: every live position must
        # have a real wpe row
        self.request_budget = min(cfg.max_len, model_config.max_position)
        self.params = prepare_params(params, cfg.dtype, self.device)
        self.cache = self._build_cache()
        # prompt buckets: block-aligned, doubling up to the cap (the
        # largest block multiple inside max_len and max_position)
        bs = cfg.block_size
        cap = min(cfg.max_len, (model_config.max_position // bs) * bs)
        self.buckets = []
        b = bs
        while b < cap:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(cap)

        self._id = next(_engine_ids)
        self._queue: "List[tuple]" = []
        self._slots: Dict[int, _Slot] = {}
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._dead: Optional[str] = None
        self._windows = 0
        self._completed = 0
        self._window_ms_ewma: Optional[float] = None
        self.health = Health.LIVE

    def _kv_scale(self) -> Optional[float]:
        """Static int8-KV dequant scale, None for float pools."""
        if self.config.kv_dtype == "int8":
            return float(self.config.kv_scale)
        return None

    # narrowest page table the bounded-walk hint ladder engages on
    _LADDER_MIN_BLOCKS = 16

    def _max_blocks_hint(self, horizon: int) -> int:
        """The furthest page-table column any slot can touch over the next
        `horizon` positions, rounded up to a power of two (capped at the
        table width), and the full width on tables of at most
        _LADDER_MIN_BLOCKS columns, as in the reference. The plain read
        path gathers only these columns; the kernel also stops at each
        slot's own frontier, so on the card the hint only caps the walk."""
        cfg = self.config
        mb = cfg.max_len // cfg.block_size
        if mb <= self._LADDER_MIN_BLOCKS:
            return mb
        mx = max((s.pos for s in self._slots.values()), default=None)
        if mx is None:
            return mb
        need = (mx + horizon - 1) // cfg.block_size + 1
        hint = 1
        while hint < need:
            hint *= 2
        return min(mb, hint)

    def _window_max_blocks(self) -> int:
        return self._max_blocks_hint(self.config.window)

    def _build_cache(self) -> PagedKVCache:
        mc, cfg = self.model_config, self.config
        nh = mc.num_heads
        pool_dtype = "int8" if cfg.kv_dtype == "int8" else cfg.dtype
        return PagedKVCache(CacheConfig(
            num_layers=mc.num_layers, num_heads=nh,
            head_dim=mc.hidden_size // nh,
            block_size=cfg.block_size, num_blocks=cfg.num_blocks,
            max_blocks_per_slot=cfg.max_len // cfg.block_size,
            dtype=pool_dtype), self.device)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    @staticmethod
    def _sample_rows(logits, temps, top_ks, seeds, gen_idx):
        """Per-slot sampling, greedy when temp == 0. logits [B, V] on the
        device; temps/top_ks/seeds/gen_idx are host arrays. Top-k and
        temperature follow models/gpt_decode._sample, whose noise is a
        pure function of (request seed, generated index) — the property
        that makes continuous batching reproducible."""
        out = torch.argmax(logits, dim=-1)
        for i in np.flatnonzero(temps > 0.0):
            out[i] = _sample(logits[i:i + 1], max(float(temps[i]), 1e-6),
                             int(top_ks[i]), int(seeds[i]),
                             int(gen_idx[i]))[0]
        return out

    def _window_fn(self, page_table, tokens, pos, gen, live, eos_vec,
                   max_new, host, max_blocks):
        """W decode steps over the slot array. Frozen rows (retired/empty
        slots, eos/length-finished mid-window) keep computing — fixed
        shapes — but their writes are redirected to the scratch block and
        their emissions flagged inactive. `host` carries the sampling
        arrays (temps, top_ks, seeds, gen); a row that is active at step s
        has generated gen + s tokens, so its draw index is known on the
        host. Returns (tokens [W, B], active [W, B]) on the device."""
        cfg = self.model_config
        p = self.params
        bs = self.config.block_size
        kv_scale = self._kv_scale()
        k_pool, v_pool = self.cache.k_pool, self.cache.v_pool
        temps, top_ks, seeds, gen_host = host
        last_pos = cfg.max_position - 1
        done = ~live
        toks, acts = [], []
        for step in range(self.config.window):
            act = ~done
            # a finished row's pos may sit one past the position table;
            # its embedding is computed and discarded
            x = p["wte"][tokens[:, None]] \
                + p["wpe"][pos.clamp(max=last_pos).long()][:, None]
            for i in range(cfg.num_layers):
                def merge(k1, v1, _i=i, _pos=pos, _act=act):
                    paged_update(k_pool, v_pool, k1[:, :, 0, :],
                                 v1[:, :, 0, :], page_table, _pos, bs, _i,
                                 active=_act, kv_scale=kv_scale)
                    return lambda q: fused_attend(
                        q, k_pool, v_pool, page_table, _pos, bs, layer=_i,
                        max_blocks=max_blocks, kv_scale=kv_scale)
                x, _ = _block(x, p, i, cfg, None, merge)
            x = _ln(x, p["final_ln_scale"], p["final_ln_bias"])
            logits = _logits(x, p)[:, 0]
            nxt = self._sample_rows(logits, temps, top_ks, seeds,
                                    gen_host + step)
            hit_eos = (eos_vec >= 0) & (nxt == eos_vec)
            gen = gen + act.int()
            done = done | (act & (hit_eos | (gen >= max_new)))
            tokens = torch.where(act, nxt, tokens)
            pos = pos + act.int()
            toks.append(nxt)
            acts.append(act)
        return torch.stack(toks), torch.stack(acts)

    def _prefill_fn(self, prompt, prompt_len: int, temp: float, top_k: int,
                    seed: int):
        """Dense causal forward over one padded prompt bucket -> per-layer
        prompt k/v [L, nh, bucket, hd] (pad positions zeroed) and the first
        sampled token (a 0-d device tensor). Same block body as the
        window."""
        cfg = self.model_config
        p = self.params
        bucket = prompt.shape[0]
        dev = self.device
        x = _embed(p, prompt[None], 0)                    # [1, bucket, H]
        idx = torch.arange(bucket, device=dev)
        causal = torch.zeros((bucket, bucket), dtype=torch.float32,
                             device=dev)
        causal = causal.masked_fill(idx[:, None] < idx[None, :],
                                    float("-inf"))
        keep = (idx < prompt_len)[None, None, :, None]
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _block(x, p, i, cfg, causal)
            ks.append(torch.where(keep, k, 0))
            vs.append(torch.where(keep, v, 0))
        k_seq = torch.stack(ks)[:, 0]
        v_seq = torch.stack(vs)[:, 0]
        x = _ln(x, p["final_ln_scale"], p["final_ln_bias"])
        logits = _logits(x[:, prompt_len - 1:prompt_len], p)[:, 0]  # [1, V]
        first = self._sample_rows(
            logits, np.array([temp], np.float32), np.array([top_k]),
            np.array([seed]), np.zeros((1,), np.int64))
        return k_seq, v_seq, first[0]

    def _write_fn(self, k_seq, v_seq, blocks: List[int]):
        """Scatter one prefilled prompt's k/v [L, nh, nb*bs, hd] into its
        assigned blocks, in place (int8 pools quantize on write)."""
        L, nh, width, hd = k_seq.shape
        bs = self.config.block_size
        nb = width // bs
        kb = k_seq.reshape(L, nh, nb, bs, hd).permute(0, 2, 1, 3, 4)
        vb = v_seq.reshape(L, nh, nb, bs, hd).permute(0, 2, 1, 3, 4)
        kv = self._kv_scale()
        if kv is not None:
            kb, vb = quantize_kv(kb, kv), quantize_kv(vb, kv)
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        k_pool, v_pool = self.cache.k_pool, self.cache.v_pool
        k_pool[:, idx] = kb.to(k_pool.dtype)
        v_pool[:, idx] = vb.to(v_pool.dtype)

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(self, request: Request, bounded: bool = True
               ) -> RequestHandle:
        """Admit or reject a request. Overload rejections finish the handle
        with `shed:<reason>` (result() raises ShedError) and count
        `serving.shed_total` + `serving.shed.<reason>`.

        `bounded=False` skips the OVERLOAD sheds (queue_full /
        deadline_unmeetable) while keeping validation and funding checks:
        batch-style callers (`generate`) submit a known, finite workload
        all at once and rely on FCFS queueing."""
        handle = RequestHandle(request)
        _metrics.inc("serving.requests")
        if self._dead:
            return shed_handle(handle, "engine_dead",
                              f"engine dead: {self._dead}")
        reason = self._reject_reason(request)
        if reason is not None:
            _metrics.inc("serving.rejected")
            handle._finish(RequestState.REJECTED, reason)
            return handle
        # a budget the pool could NEVER fund must shed now, not park at
        # the FCFS head forever wedging every request behind it
        plen = int(request.prompt.shape[0])
        usable = self.config.num_blocks - 1
        need = self._block_budget(plen, request.max_new_tokens)
        if need > usable:
            return shed_handle(
                handle, "unfundable",
                f"request needs {need} cache blocks but the pool has "
                f"only {usable} (num_blocks={self.config.num_blocks} "
                "incl. scratch)")
        if bounded:
            with self._cv:
                depth = len(self._queue)
            if depth >= self.config.max_queue:
                return shed_handle(
                    handle, "queue_full",
                    f"submit queue at its bound "
                    f"({self.config.max_queue})")
            if request.deadline_ms is not None:
                est = self.queue_wait_estimate_ms()
                if est > request.deadline_ms:
                    return shed_handle(
                        handle, "deadline_unmeetable",
                        f"estimated queue wait {est:.0f} ms exceeds "
                        f"request deadline {request.deadline_ms:.0f} ms")
        with self._cv:
            entry = (request, handle)
            self._queue.append(entry)
            _metrics.set_gauge("serving.queue_depth", len(self._queue))
            self._ensure_thread()
            self._cv.notify_all()
        if self._dead is not None and self._unqueue(entry):
            # the engine died between the liveness check and the append:
            # the fail snapshot missed this entry
            return shed_handle(handle, "engine_dead",
                              f"engine died during submit: {self._dead}")
        return handle

    def _unqueue(self, entry) -> bool:
        """Remove a just-appended queue entry if it is still there (False
        means the service/fail path already claimed it). Matches by
        IDENTITY: Request carries an ndarray whose truth value raises."""
        with self._cv:
            for i, e in enumerate(self._queue):
                if e is entry:
                    del self._queue[i]
                    _metrics.set_gauge("serving.queue_depth",
                                       len(self._queue))
                    return True
            return False

    def _block_budget(self, plen: int, max_new: int) -> int:
        bs = self.config.block_size
        return max(self._bucket_for(plen) // bs, -(-(plen + max_new) // bs))

    def _reject_reason(self, req: Request) -> Optional[str]:
        """Validation-only rejects (malformed requests); capacity-driven
        rejections go through the shed taxonomy instead."""
        plen = int(req.prompt.shape[0])
        if plen < 1:
            return "empty prompt"
        if req.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        if req.temperature < 0.0:
            return f"temperature must be >= 0, got {req.temperature}"
        if req.top_k < 0:
            return f"top_k must be >= 0, got {req.top_k}"
        if plen + req.max_new_tokens > self.request_budget:
            return (f"prompt {plen} + {req.max_new_tokens} new exceeds "
                    f"engine budget {self.request_budget} "
                    f"(max_len/max_position)")
        if plen > self.buckets[-1]:
            return (f"prompt {plen} exceeds the largest prefill bucket "
                    f"{self.buckets[-1]} (block-aligned max_position)")
        if int(req.prompt.min()) < 0 or \
                int(req.prompt.max()) >= self.model_config.vocab_size:
            return (f"prompt token ids must lie in [0, "
                    f"{self.model_config.vocab_size})")
        return None

    def load(self) -> int:
        """Pending decode tokens (queued + in-flight remaining)."""
        with self._cv:
            queued = sum(r.max_new_tokens for r, _ in self._queue)
            active = sum(max(s.max_new - s.gen, 0)
                         for s in self._slots.values())
        return queued + active

    def queue_wait_estimate_ms(self) -> float:
        """Pending tokens over the window throughput, scaled by the
        measured window wall time (EWMA). 0.0 until the first window."""
        ewma = self._window_ms_ewma
        if not ewma:
            return 0.0
        per_window = max(self.config.window * self.config.max_slots, 1)
        return self.load() / per_window * ewma

    def generate(self, requests: List[Request],
                 timeout: float = 300.0) -> List[Completion]:
        """Continuous-batched: submit everything, wait for everything."""
        handles = [self.submit(r, bounded=False) for r in requests]
        return [h.result(timeout=timeout, raise_on_error=False)
                for h in handles]

    def generate_sequential(self, requests: List[Request],
                            timeout: float = 300.0) -> List[Completion]:
        """The parity baseline: one request at a time, each fully retired
        before the next is submitted — same slot array, one live slot."""
        return [self.submit(r, bounded=False).result(
                    timeout=timeout, raise_on_error=False)
                for r in requests]

    # ------------------------------------------------------------------
    # service loop
    # ------------------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._service_loop, daemon=True,
                name=f"serving-engine-{self._id}")
            self._thread.start()

    def start(self):
        with self._cv:
            self._ensure_thread()
        return self

    def stop(self, join_timeout_s: float = 60.0):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=join_timeout_s)
        if self._queue or self._slots:
            # stop() abandons in-flight work: their callers must get a
            # terminal FAILED completion, never block forever
            self._fail_all("engine stopped")
        self.cache.close()   # retire this pool from the process gauges

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    def _service_loop(self):
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stop and not self._slots
                           and not self._queue):
                        self._cv.wait(0.05)
                    if self._stop:
                        break
                try:
                    self._admit()
                    if self._slots:
                        self._run_window()
                except Exception as e:  # noqa: BLE001 — fail requests, die
                    # the thread's boundary: every waiter gets a terminal
                    # completion carrying the traceback
                    self._fail_all(f"{e!r}\n{traceback.format_exc()}")
                    break

    def _fail_all(self, why: str):
        """The engine is dead: every queued and in-flight request fails
        typed."""
        self._dead = why
        self.health = Health.DEAD
        _metrics.inc("serving.engine_failures")
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            slots = dict(self._slots)
            self._slots.clear()
            _metrics.set_gauge("serving.queue_depth", 0)
        for idx in slots:
            self.cache.release(idx)
        victims = [handle for _, handle in pending]
        victims += [slot.handle for slot in slots.values()]
        for handle in victims:
            handle._finish(RequestState.FAILED, "engine failed", error=why)

    # ---- admission -------------------------------------------------------
    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        return self.buckets[-1]

    def _admit(self):
        while True:
            with self._cv:
                if not self._queue:
                    return
                entry = self._queue[0]
                req, handle = entry
            free = [i for i in range(self.config.max_slots)
                    if i not in self._slots]
            if not free:
                return
            plen = int(req.prompt.shape[0])
            bucket = self._bucket_for(plen)
            slot_idx = free[0]
            blocks = self.cache.assign(
                slot_idx, self._block_budget(plen, req.max_new_tokens))
            if blocks is None:
                # FCFS: wait for a retirement to free blocks rather than
                # starving big requests behind small ones
                return
            with self._cv:
                # re-verify the head: a concurrent stop() may have claimed
                # the entry while the lock was released
                head_claimed = not self._queue or self._queue[0] is not entry
                if not head_claimed:
                    self._queue.pop(0)
                    _metrics.set_gauge("serving.queue_depth",
                                       len(self._queue))
            if head_claimed:
                self.cache.release(slot_idx)
                return
            _metrics.observe(
                "serving.queue_wait_ms",
                (time.perf_counter() - handle.t_submit) * 1000.0)
            try:
                self._prefill_into(slot_idx, blocks, req, handle, plen,
                                   bucket)
            except Exception as e:  # noqa: BLE001 — isolate to the request
                # a per-request admission failure fails THAT request, not
                # the engine and everything in flight
                if self.cache.blocks_of(slot_idx):
                    self.cache.release(slot_idx)
                with self._cv:
                    self._slots.pop(slot_idx, None)
                _metrics.inc("serving.prefill_failures")
                handle._finish(RequestState.FAILED, "prefill failed",
                               error=f"{e!r}\n{traceback.format_exc()}")

    def _prefill_into(self, slot_idx, blocks, req, handle, plen, bucket):
        handle._set_state(RequestState.PREFILL)
        _metrics.inc("serving.prefills")
        first = self._cold_prefill(req, plen, bucket, blocks)
        # TTFT is measured at HOST materialization of the first token
        tok = int(first)
        handle._append_tokens([tok])
        handle._set_state(RequestState.DECODE)
        if not handle._ttft_observed:
            handle._ttft_observed = True
            _metrics.observe("serving.ttft_ms", handle.ttft_ms())
        eos = -1 if req.eos_token is None else int(req.eos_token)
        if req.max_new_tokens == 1 or tok == eos:
            self.cache.release(slot_idx)
            self._retire(handle, "eos" if tok == eos else "length")
            return
        with self._cv:    # load()/stats() iterate _slots cross-thread
            self._slots[slot_idx] = _Slot(
                handle, pos=plen, gen=1, token=tok, eos=eos,
                max_new=req.max_new_tokens, temp=float(req.temperature),
                top_k=int(req.top_k), seed=int(req.seed))
        _metrics.set_gauge("serving.active_slots", len(self._slots))

    def _cold_prefill(self, req, plen, bucket, blocks):
        """Dense prefill over the whole padded prompt bucket + block
        scatter."""
        padded = np.zeros((bucket,), np.int64)
        padded[:plen] = req.prompt
        k_seq, v_seq, first = self._prefill_fn(
            torch.as_tensor(padded, device=self.device), plen,
            float(req.temperature), int(req.top_k), int(req.seed))
        self._write_fn(k_seq, v_seq, blocks[:bucket // self.config.block_size])
        return first

    def _retire(self, handle, reason: str):
        handle._finish(RequestState.DONE, reason)
        self._completed += 1
        _metrics.inc("serving.completed")
        tpot = handle.tpot_ms()
        if tpot is not None:
            _metrics.observe("serving.tpot_ms", tpot)

    # ---- decode window ---------------------------------------------------
    def _window_args(self):
        """The window's inputs: device tensors for the per-step state and
        host arrays for the per-row sampling."""
        B = self.config.max_slots
        tokens = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        gen = np.zeros((B,), np.int32)
        live = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        eos = np.full((B,), -1, np.int64)
        max_new = np.full((B,), 1, np.int32)
        for i, s in self._slots.items():
            tokens[i], pos[i], gen[i] = s.token, s.pos, s.gen
            live[i], temps[i], top_ks[i] = True, s.temp, s.top_k
            seeds[i], eos[i], max_new[i] = s.seed, s.eos, s.max_new
        dev = self.device
        pt = self.cache.page_table_rows(B)
        on_dev = tuple(torch.as_tensor(a, device=dev) for a in
                       (pt, tokens, pos, gen, live, eos, max_new))
        return on_dev + ((temps, top_ks, seeds, gen.astype(np.int64)),)

    def _run_window(self):
        self._windows += 1
        _metrics.inc("serving.windows")
        args = self._window_args()
        t0 = time.perf_counter()
        toks, acts = self._window_fn(*args, self._window_max_blocks())
        # the window's one host sync: its tokens and activity flags
        toks, acts = toks.cpu().numpy(), acts.cpu().numpy()
        window_ms = (time.perf_counter() - t0) * 1000.0
        _metrics.observe("serving.window_ms", window_ms)
        # EWMA of window wall time: the queue-wait estimator's clock
        self._window_ms_ewma = (
            window_ms if self._window_ms_ewma is None
            else 0.8 * self._window_ms_ewma + 0.2 * window_ms)
        self._apply_window(toks, acts)

    def _apply_slot_tokens(self, idx: int, slot: _Slot, tokens) -> int:
        """Host-side walk of one slot's emitted tokens (eos/length
        truncation). Appends to the handle, retires the slot when it
        finishes. Returns the number of tokens emitted."""
        emitted = []
        finished = None
        for tok in tokens:
            tok = int(tok)
            emitted.append(tok)
            slot.gen += 1
            slot.pos += 1
            slot.token = tok
            if tok == slot.eos:
                finished = "eos"
                break
            if slot.gen >= slot.max_new:
                finished = "length"
                break
        if emitted:
            slot.handle._append_tokens(emitted)
        if finished is not None:
            self.cache.release(idx)
            with self._cv:    # load()/stats() iterate cross-thread
                self._slots.pop(idx, None)
            self._retire(slot.handle, finished)
        return len(emitted)

    def _apply_window(self, toks: np.ndarray, acts: np.ndarray):
        n_tokens = 0
        for idx in list(self._slots):
            slot = self._slots.get(idx)
            if slot is None:
                continue
            run = []
            for t in range(toks.shape[0]):
                if not acts[t, idx]:
                    break
                run.append(int(toks[t, idx]))
            n_tokens += self._apply_slot_tokens(idx, slot, run)
        _metrics.inc("serving.tokens_out", n_tokens)
        _metrics.set_gauge("serving.active_slots", len(self._slots))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "windows": self._windows,
            "completed": self._completed,
            "active_slots": len(self._slots),
            "queued": len(self._queue),
            "free_blocks": self.cache.allocator.free_blocks,
            "dead": self._dead,
            "health": self.health,
            "load": self.load(),
        }
