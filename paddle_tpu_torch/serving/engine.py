"""Continuous-batching decode engine over the paged KV cache (counterpart of
paddle_tpu/serving/engine.py).

Iteration-level scheduling (Orca, OSDI '22): the engine owns a FIXED slot
array of width `max_slots` and decodes in `window`-token windows. Between
windows (and only between windows) the service thread retires finished
slots and admits queued requests, so batch composition churns freely while
every window runs the same shapes.

Each admitted request is prefilled once and its prompt k/v is written into
the blocks its slot was funded with; the slot joins the next window.
Every window step runs the SAME transformer block body as
models/gpt_decode (`_block`) with a merge hook that writes the new position
into the pools in place and attends through `ops.paged_ops.fused_attend`:
the hand-written CUDA kernel on the card, its plain PyTorch version on CPU
tensors. There is no switch between the two: the tensors' device decides.

One captured window. The reference compiles its W-step window into one
`lax.scan` dispatch; the port's counterpart is a CUDA graph. On a CUDA
engine each window copies its inputs (tokens, pos, gen, live, eos,
max_new, temps, top_ks, seeds, the page table) into static buffers and
replays a graph of the whole window, captured once per engine at the full
page-table width (B4 stops at each slot's frontier, so the width costs
only empty blocks) on the service thread, on a side stream after one
warm-up call with every row inactive (writes land on the scratch
block). The pools are written in place at fixed addresses and
sampling is a device-side counter hash (`gpt_decode.sample_rows`), so
nothing in the window touches the host: its one sync is the `.cpu()` of
its tokens. A failed capture raises; a CUDA engine never decodes eagerly.
A CPU engine runs the same window body eagerly (`_eager_call`).

Prefill runs in chunks of `prefill_chunk` rows against a k/v buffer of one
fixed width per engine, so every prefill GEMM and attention has the same
shape whatever the prompt length: a row's bits then depend only on its
own inputs, which is what lets the radix prefix cache (`prefix_cache=
True`) skip the chunks a cached prefix covers and still give the tokens a
cold prefill gives, on any BLAS.

Speculative decoding (`spec=`, serving/spec.py) replaces windows with
rounds: the draft arm's own captured window proposes, and a captured
verify pass scores gamma+1 positions per slot as window-shaped [B, 1, H]
products (`_verify_eager`), so spec-on tokens equal spec-off tokens.

Sampling is per slot and a pure function of (request seed, generated
index), so a request's tokens do not depend on which slot or window
carries it: continuous batching gives the tokens one-at-a-time decoding
gives (`generate_sequential`), and a request re-dispatched to another
replica after an engine death replays its tokens bit for bit.

Resilience (serving/resilience.py drives it):

* every request is one trace flow (submit -> retire) and every window a
  span with a dispatch -> materialization flow and a flight-recorder step
  on this engine's lane (observability/);
* fault sites `serving.admit`, `serving.prefill` and `serving.window`
  (resilience/faults.py), all on the host and before any replay;
* `FLAGS_step_deadline_ms` bounds each window's and verify pass's
  static-input copy, replay and `.cpu()` (framework/executor.py
  `_deadline_call`, on this engine's stream); a trip raises the typed
  DeadlineExceededError, flight-dumps and kills the engine;
* `kill`, `drain` and `resurrect`; a dying engine hands its in-flight
  requests to the frontend's failover sink when one is installed and
  fails them typed otherwise.

A CUDA engine runs all its work (prefill, capture, replays, resets) on a
stream of its own, so replicas overlap on the card and a watchdog's
worker thread replays on the same stream as the service thread.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import (DeviceLike, capture_lock, collector_paused,
                      resolve_device)
from ..flags import flag
from ..framework import errors as _errors
from ..framework.executor import _deadline_call, _on_stream
from ..models.gpt import GPTConfig
from ..models.gpt_decode import (_block, _block_out, _block_qkv, _ln,
                                 _logits, fold_seed, sample_rows)
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..ops.kernels import paged_attention as _kernel
from ..ops.paged_ops import (fused_attend, paged_attend_span, paged_update,
                             paged_update_span, quantize_kv)
from ..resilience.faults import FaultInjected, fault_point
from .cache import CacheConfig, PagedKVCache, RadixPrefixCache
from .request import Completion, Request, RequestHandle, RequestState
from .resilience import Health, shed_handle
from .weights import dequant_params, prepare_params

_engine_ids = itertools.count(1)
# how long `resurrect` waits for the dead engine's threads and device work
_QUIET_TIMEOUT_S = 2.0

# most rows of one prefill chunk: one GEMM shape for every prefill of an
# engine, small enough that a cached prefix spares whole chunks, large
# enough to keep the launches per prefill few
_PREFILL_CHUNK = 64


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
    dtype: str = "float32"      # "float32" | "bfloat16" | "int8" (weights)
    max_queue: int = 0          # submit-queue bound (admission control)
    kv_dtype: str = ""          # "" = compute dtype; "int8" = quantized
                                # KV pools (abs-max grid, static kv_scale)
    kv_scale: float = 8.0       # int8-KV abs-max clip range
    # radix prefix cache: retired requests publish their prompt block
    # chains; admission maps the longest cached prefix read-only and
    # prefills only the chunks it does not cover. Cache-on tokens ==
    # cache-off tokens; refused with int8 KV pools (a cached prefix would
    # be re-read through dequant)
    prefix_cache: bool = False
    # speculative decoding (serving/spec.py): None/False = off; True = the
    # default SpecConfig (int8 draft arm of the same checkpoint, gamma =
    # FLAGS_serving_spec_tokens); a SpecConfig pins the draft
    spec: Optional[object] = None
    # set by resolve(): the budget the caller asked for, before rounding
    # (the max_position guard compares this, so re-resolving a rounded
    # config, as a replica clone does, never trips on the rounding)
    requested_max_len: Optional[int] = None

    def resolve(self) -> "EngineConfig":
        c = dataclasses.replace(self)
        if c.requested_max_len is None:
            c.requested_max_len = c.max_len
        if not c.block_size:
            c.block_size = int(flag("FLAGS_serving_block_size"))
        if not c.window:
            c.window = int(flag("FLAGS_serving_window"))
        if not c.max_queue:
            c.max_queue = int(flag("FLAGS_serving_max_queue"))
        if c.max_len % c.block_size:
            c.max_len += c.block_size - c.max_len % c.block_size
        if c.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"serving dtype {c.dtype!r} not in "
                             "(float32, bfloat16, int8)")
        if c.kv_dtype not in ("", "int8"):
            raise ValueError(f"kv_dtype must be '' or 'int8', "
                             f"got {c.kv_dtype!r}")
        if c.prefix_cache and c.kv_dtype == "int8":
            raise ValueError(
                "prefix_cache requires float KV pools: int8 pools "
                "quantize on write, so a shared prefix would be re-read "
                "through dequant and break the cache-on == cache-off "
                "contract")
        if c.spec is False:
            c.spec = None
        if c.spec is not None:
            from .spec import SpecConfig
            c.spec = (SpecConfig() if c.spec is True else c.spec).resolve()
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


class _Captured:
    """A CUDA graph of one call of `body` over static input buffers.

    The capture runs on the calling thread, on a side stream, after one
    warm-up call with every input zero: every row inactive and every
    page-table entry the scratch block, so the warm-up writes nothing a
    slot reads. One capture runs at a time in the process, an
    Executor's included (`device.capture_lock`), with the cyclic
    collector paused (`collector_paused`). The B4 launches the capture
    recorded (on this thread only, `capture_launches`) are counted again
    at every replay."""

    def __init__(self, body, inputs: Dict[str, torch.Tensor], pool):
        self.inputs = inputs
        dev = next(iter(inputs.values())).device
        for t in inputs.values():
            t.zero_()
        side = torch.cuda.Stream(dev)
        with capture_lock:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body(inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with collector_paused(), _kernel.capture_launches() as rec, \
                    torch.cuda.graph(self.graph, pool=pool, stream=side,
                                     capture_error_mode="thread_local"):
                self.out = body(inputs)
        self.launches = rec

    def replay(self, host: Dict[str, np.ndarray]):
        for k, a in host.items():
            self.inputs[k].copy_(torch.from_numpy(a))
        self.graph.replay()
        _kernel.count_replay(self.launches)
        return self.out


class DecodeEngine:
    """One decode worker: a slot array, a paged cache on `device` (default
    cuda), and the service thread interleaving admission with decode
    windows.

    `_prepared` / `_draft_prepared` are the replica path
    (frontend._clone_engine): the engine adopts another engine's prepared
    weight tensors, and its draft's, instead of preparing its own, so
    replicas hold one weight copy and add only their pools, graphs and
    static buffers."""

    def __init__(self, params: Optional[Dict], model_config: GPTConfig,
                 config: Optional[EngineConfig] = None,
                 device: DeviceLike = None,
                 _prepared: Optional[tuple] = None,
                 _draft_prepared: Optional[tuple] = None, **overrides):
        self.device = resolve_device(device)
        self.model_config = model_config
        if config is not None and overrides:
            raise ValueError("pass EngineConfig or overrides, not both")
        raw = config or EngineConfig(**overrides)
        # guard on the REQUESTED budget; resolve() then rounds max_len up
        # to a block multiple, which only widens the (masked) cache view
        requested = (raw.requested_max_len
                     if raw.requested_max_len is not None else raw.max_len)
        if requested > model_config.max_position:
            raise ValueError(
                f"max_len {requested} exceeds model max_position "
                f"{model_config.max_position}")
        cfg = raw.resolve()
        self.config = cfg
        # per-request prompt+generation ceiling: every live position must
        # have a real wpe row
        self.request_budget = min(cfg.max_len, model_config.max_position)
        if _prepared is not None:
            self.params, self.scales, self.compute_dtype = _prepared
        else:
            self.params, self.scales, self.compute_dtype = prepare_params(
                params, cfg.dtype, self.device)
        # the stream all of this engine's device work runs on
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.cache = self._build_cache()
        # prompt buckets (the block budget): block-aligned, doubling up to
        # the cap (the largest block multiple inside max_len and
        # max_position)
        bs = cfg.block_size
        cap = min(cfg.max_len, (model_config.max_position // bs) * bs)
        self.buckets = []
        b = bs
        while b < cap:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(cap)
        # prefill geometry, the same for every prompt: chunks of a quarter
        # of the cap (a block multiple, at most _PREFILL_CHUNK rows)
        # attending a k/v buffer of prefill_width columns
        self.prefill_chunk = max(bs, min(_PREFILL_CHUNK, cap // 4) // bs * bs)
        self.prefill_width = -(-cap // self.prefill_chunk) \
            * self.prefill_chunk

        self._id = next(_engine_ids)
        self._queue: "List[tuple]" = []
        self._admitting: Optional[tuple] = None   # popped, not yet slotted
        self._slots: Dict[int, _Slot] = {}
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._dead: Optional[str] = None
        self._kill: Optional[str] = None
        self._draining = False
        self._windows = 0
        self._completed = 0
        self._window_ms_ewma: Optional[float] = None
        # health + failover (serving/resilience.py): a ServingFrontend
        # installs its failover sink here; a standalone engine keeps the
        # fail-hard semantics (sink None)
        self.health = Health.LIVE
        self.health_history: List[str] = [Health.LIVE]
        self._failover: Optional[Callable] = None
        self._died_at: Optional[float] = None     # perf_counter of death
        # the watchdog worker a trip abandoned, still replaying maybe
        self._abandoned = None
        # the captured window and verify pass; one graph memory pool and
        # one set of static inputs per engine
        self._graphs: Dict[str, _Captured] = {}
        self._static: Dict[str, torch.Tensor] = {}
        self._pool = None
        self._replays = 0
        self._eager_calls = 0
        # kernel launches made by replays, by call kind
        self._graph_launches = {"window": 0, "verify": 0}
        self.prefix_cache = (RadixPrefixCache(cfg.block_size)
                             if cfg.prefix_cache else None)
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefill_tokens_saved = 0
        self.spec = None
        if cfg.spec is not None:
            from .spec import SpecDecoder
            self.spec = SpecDecoder(self, cfg.spec, raw_params=params,
                                    _draft_prepared=_draft_prepared)
        if self._stream is not None:
            # the weights (a clone's too) and the zeroed pools were made on
            # the caller's stream; order the engine's stream after them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _kv_scale(self) -> Optional[float]:
        """Static int8-KV dequant scale, None for float pools."""
        if self.config.kv_dtype == "int8":
            return float(self.config.kv_scale)
        return None

    def _set_health(self, state: str):
        if state != self.health:
            self.health = state
            self.health_history.append(state)
            del self.health_history[:-64]   # bounded
            _trace.instant("serving.health",
                           args={"engine": self._id, "state": state})

    def _build_cache(self) -> PagedKVCache:
        mc, cfg = self.model_config, self.config
        nh = mc.num_heads
        pool_dtype = "int8" if cfg.kv_dtype == "int8" \
            else str(self.compute_dtype).replace("torch.", "")
        return PagedKVCache(CacheConfig(
            num_layers=mc.num_layers, num_heads=nh,
            head_dim=mc.hidden_size // nh,
            block_size=cfg.block_size, num_blocks=cfg.num_blocks,
            max_blocks_per_slot=cfg.max_len // cfg.block_size,
            dtype=pool_dtype), self.device)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _model_params(self):
        """The dense parameters: int8 payloads dequantized here, inside the
        window or prefill that uses them, so the payload is what stays
        resident."""
        if self.scales is None:
            return self.params
        return dequant_params(self.params, self.scales, self.compute_dtype)

    def _window_eager(self, st: Dict[str, torch.Tensor]):
        """W decode steps over the slot array, the body a window graph
        captures. Frozen rows (retired/empty slots, eos/length-finished
        mid-window) keep computing — fixed shapes — but their writes are
        redirected to the scratch block and their emissions flagged
        inactive. A row active at step s draws with index gen + s.
        Returns (tokens [W, B], active [W, B])."""
        cfg = self.model_config
        p = self._model_params()
        bs = self.config.block_size
        kv_scale = self._kv_scale()
        k_pool, v_pool = self.cache.k_pool, self.cache.v_pool
        page_table = st["page_table"]
        tokens, pos, gen = st["tokens"], st["pos"], st["gen"]
        eos_vec, max_new = st["eos"], st["max_new"]
        last_pos = cfg.max_position - 1
        done = ~st["live"]
        toks, acts = [], []
        for _ in range(self.config.window):
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
                        kv_scale=kv_scale)
                x, _ = _block(x, p, i, cfg, None, merge)
            x = _ln(x, p["final_ln_scale"], p["final_ln_bias"])
            nxt = sample_rows(_logits(x, p)[:, 0], st["temps"],
                              st["top_ks"], st["seeds"], gen.long())
            hit_eos = (eos_vec >= 0) & (nxt == eos_vec)
            gen = gen + act.int()
            done = done | (act & (hit_eos | (gen >= max_new)))
            tokens = torch.where(act, nxt, tokens)
            pos = pos + act.int()
            toks.append(nxt)
            acts.append(act)
        return torch.stack(toks), torch.stack(acts)

    def _verify_eager(self, st: Dict[str, torch.Tensor]):
        """The speculative verify pass, the body a verify graph captures:
        scores span = gamma+1 candidate positions per slot — pos..pos+span-1
        hold the slot's current token and the draft's proposals (`cand`
        [B, span]). Layer by layer, each position's products run as the
        window's [B, 1, H] products (`_block_qkv` / `_block_out`), the
        span's k/v are written (`paged_update_span`, invalid positions to
        scratch) and each row attends at its own position
        (`paged_attend_span`, B4 per row), so row s carries the bits a
        window step at pos+s computes. Row s samples at index gen + s with
        the window's rule. Returns (vtok [B, span], n_acc [B]): the
        target's token at every position and the length of the longest
        prefix of proposals equal to it."""
        cfg = self.model_config
        p = self._model_params()
        bs = self.config.block_size
        kv_scale = self._kv_scale()
        k_pool, v_pool = self.cache.k_pool, self.cache.v_pool
        page_table, cand, pos = st["page_table"], st["cand"], st["pos"]
        valid, gen = st["valid"], st["gen"].long()
        span = cand.shape[1]
        last_pos = cfg.max_position - 1
        xs = [p["wte"][cand[:, s:s + 1]]
              + p["wpe"][(pos + s).clamp(max=last_pos).long()][:, None]
              for s in range(span)]
        for i in range(cfg.num_layers):
            q, k, v = (torch.cat(t, dim=2) for t in zip(
                *(_block_qkv(x, p, i, cfg) for x in xs)))
            paged_update_span(k_pool, v_pool, k, v, page_table, pos, bs, i,
                              active=st["live"], valid=valid,
                              kv_scale=kv_scale)
            ctx = paged_attend_span(q, k_pool, v_pool, page_table, pos, bs,
                                    layer=i, kv_scale=kv_scale)
            xs = [_block_out(x, ctx[:, :, s:s + 1].contiguous(), p, i)
                  for s, x in enumerate(xs)]
        vtok = torch.stack(
            [sample_rows(_logits(_ln(x, p["final_ln_scale"],
                                     p["final_ln_bias"]), p)[:, 0],
                         st["temps"], st["top_ks"], st["seeds"], gen + s)
             for s, x in enumerate(xs)], dim=1)
        agree = (cand[:, 1:] == vtok[:, :-1]) & valid[:, 1:]
        n_acc = torch.cumprod(agree.int(), dim=1).sum(dim=1)
        return vtok, n_acc

    def _eager_call(self, key: str, body, host: Dict[str, np.ndarray]):
        """Run `body` on the host arrays as device tensors, no graph: the
        CPU engine's path (and chip_smoke.py's eager arm)."""
        self._eager_calls += 1
        return body({k: torch.as_tensor(a, device=self.device)
                     for k, a in host.items()})

    def _graph(self, key: str, body, host: Dict[str, np.ndarray]
               ) -> Optional[_Captured]:
        """The graph captured for `key` ("window" / "verify") on a CUDA
        engine, captured on first use; None on a CPU engine. A capture
        that fails raises."""
        if self.device.type != "cuda":
            return None
        g = self._graphs.get(key)
        if g is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            for k, a in host.items():
                if k not in self._static:     # shapes are fixed per engine
                    self._static[k] = torch.empty(
                        a.shape, dtype=torch.from_numpy(a).dtype,
                        device=self.device)
            g = self._graphs[key] = _Captured(
                body, {k: self._static[k] for k in host}, self._pool)
            _metrics.inc("serving.graph_captures")
        return g

    def _call(self, key: str, body, host: Dict[str, np.ndarray]):
        """One window or verify call. CPU engines run `body` eagerly; a
        CUDA engine replays the graph captured for `key`, capturing it on
        first use."""
        g = self._graph(key, body, host)
        if g is None:
            return self._eager_call(key, body, host)
        self._replays += 1
        self._graph_launches[key] += sum(g.launches.values())
        return g.replay(host)

    def _watched(self, key: str, body, host: Dict[str, np.ndarray],
                 span: str, fetch: str):
        """The envelope of one window or verify call: a flight-recorder
        step on this engine's lane, a trace span with a dispatch ->
        materialization flow, and, when FLAGS_step_deadline_ms > 0, the
        watchdog around the static-input copy, the replay and the
        `.cpu()`. A first call captures its graph here, outside the
        watchdog. Returns the two outputs as host arrays."""
        self._graph(key, body, host)
        owner = 0x5E0 + self._id
        step = self._windows
        active = len(self._slots)
        fid = _trace.new_flow()

        def dispatch():
            with _trace.RecordEvent(span, args={"window": step,
                                                "active": active}):
                _trace.flow_start("serving.window_fetch", fid)
                first, second = self._call(key, body, host)
                with _trace.RecordEvent("fetch.materialize",
                                        args={"name": fetch}):
                    first = first.cpu().numpy()
                _trace.flow_end("fetch", fid, args={"name": fetch})
                return first, second.cpu().numpy()

        def tripped(worker):
            self._abandoned = worker
            _flight.end_step(step, status="sla_trip", owner=owner)

        _flight.begin_step(step, owner=owner)
        status = "ok"
        deadline = float(flag("FLAGS_step_deadline_ms") or 0.0)
        try:
            if deadline > 0:
                return _deadline_call(
                    dispatch, deadline,
                    f"serving {key} ({active} active slots)",
                    device=self.device, stream=self._stream,
                    on_trip=tripped)
            return dispatch()
        except _errors.DeadlineExceededError:
            status = "sla_trip"
            _metrics.inc("serving.sla_trips")
            raise
        except BaseException:
            status = "error"
            raise
        finally:
            _flight.end_step(step, status=status, owner=owner)

    def _chunk_forward(self, p, chunk_tokens, lo: int, kbuf, vbuf,
                       keep_from: int):
        """One prefill chunk: positions lo..lo+C-1 through every layer,
        attending the per-layer k/v buffers [1, nh, W, hd] (fixed width W)
        causally. The chunk's k/v land in the buffers at columns >=
        `keep_from`; columns below it hold a cached prefix. Returns the
        chunk's last hidden states [1, C, H]."""
        cfg = self.model_config
        dev = self.device
        c = chunk_tokens.shape[0]
        width = kbuf[0].shape[2]
        rows = torch.arange(lo, lo + c, device=dev)
        x = p["wte"][chunk_tokens[None]] \
            + p["wpe"][rows.clamp(max=cfg.max_position - 1)][None]
        cols = torch.arange(width, device=dev)
        mask = torch.zeros((c, width), dtype=torch.float32, device=dev)
        mask = mask.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        off = max(keep_from - lo, 0)
        for i in range(cfg.num_layers):
            def merge(k1, v1, _i=i):
                kbuf[_i][:, :, lo + off:lo + c] = k1[:, :, off:]
                vbuf[_i][:, :, lo + off:lo + c] = v1[:, :, off:]
                return kbuf[_i], vbuf[_i]
            x, _ = _block(x, p, i, cfg, mask, merge)
        return x

    def _prefill_fn(self, tokens: np.ndarray, plen: int, temp: float,
                    top_k: int, seed: int, prefix_kv=None, matched=0):
        """Prefill one prompt in chunks of `prefill_chunk` rows against k/v
        buffers of `prefill_width` columns. A cold prefill runs every chunk
        of the prompt; a prefix-cache hit (`prefix_kv` = the cached k/v
        [L, nh, matched, hd] gathered from the pool) fills the buffers'
        first `matched` columns with it and runs only the chunks from the
        one holding position `matched`. Every chunk has the same shapes
        and a chunk's rows the same inputs in both cases, so both give the
        same bits. Returns (k, v [L, nh, W, hd], first token as a 0-d
        device tensor)."""
        cfg = self.model_config
        p = self._model_params()
        dev = self.device
        C, W = self.prefill_chunk, self.prefill_width
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        padded = np.zeros((-(-plen // C) * C,), np.int64)
        padded[:plen] = tokens[:plen]
        tok = torch.as_tensor(padded, device=dev)
        shape = (1, nh, W, hd)
        # the activations' dtype: f32 in the int8-weight arm (its f32
        # biases promote them), as the reference's dense prefill keeps k/v
        act = torch.float32 if self.config.dtype == "int8" \
            else self.compute_dtype
        kbuf = [torch.zeros(shape, dtype=act, device=dev)
                for _ in range(cfg.num_layers)]
        vbuf = [torch.zeros(shape, dtype=act, device=dev)
                for _ in range(cfg.num_layers)]
        if matched:
            for i in range(cfg.num_layers):
                kbuf[i][0, :, :matched] = prefix_kv[0][i]
                vbuf[i][0, :, :matched] = prefix_kv[1][i]
        last = (plen - 1) // C
        for c in range(matched // C, last + 1):
            x = self._chunk_forward(p, tok[c * C:(c + 1) * C], c * C,
                                    kbuf, vbuf, matched)
        x = _ln(x, p["final_ln_scale"], p["final_ln_bias"])
        row = plen - 1 - last * C
        # slice the last real position BEFORE the [H, V] head matmul
        logits = _logits(x[:, row:row + 1], p)[:, 0]          # [1, V]
        first = sample_rows(
            logits, torch.tensor([float(temp)], device=dev),
            torch.tensor([int(top_k)], device=dev),
            torch.tensor([fold_seed(seed)], device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev))
        return torch.cat(kbuf), torch.cat(vbuf), first[0]

    def _write_fn(self, k_seq, v_seq, blocks: List[int], lo: int,
                  plen: int):
        """Write prompt positions lo..plen-1 of k_seq/v_seq [L, nh, W, hd]
        into `blocks`, the slot's blocks from the one holding position lo
        (a block multiple), in place. Rows past plen in the last block are
        zeroed; int8 pools quantize on write."""
        L, nh, _, hd = k_seq.shape
        bs = self.config.block_size
        nb = len(blocks)
        hi = lo + nb * bs
        keep = (torch.arange(lo, hi, device=self.device)
                < plen)[None, None, :, None]
        kb = torch.where(keep, k_seq[:, :, lo:hi], 0) \
            .reshape(L, nh, nb, bs, hd).permute(0, 2, 1, 3, 4)
        vb = torch.where(keep, v_seq[:, :, lo:hi], 0) \
            .reshape(L, nh, nb, bs, hd).permute(0, 2, 1, 3, 4)
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
    def submit(self, request: Request,
               _handle: Optional[RequestHandle] = None,
               _failover: bool = False, _probe: bool = False,
               bounded: bool = True) -> Optional[RequestHandle]:
        """Admit or reject a request. Overload rejections finish the handle
        with `shed:<reason>` (result() raises ShedError) and count
        `serving.shed_total` + `serving.shed.<reason>`.

        `bounded=False` skips the OVERLOAD sheds (queue_full /
        deadline_unmeetable) while keeping validation and funding checks:
        batch-style callers (`generate`) submit a known, finite workload
        all at once and rely on FCFS queueing.

        `_failover=True` is the frontend's re-dispatch path: `_handle` is
        work already admitted elsewhere, so admission control is skipped
        and a dead, draining or stopped engine returns None (the handle
        untouched; the caller tries the next replica). `_probe=True` (the
        frontend's routing path) likewise returns None instead of a shed
        handle on such an engine, so a routing retry that lands elsewhere
        counts no shed."""
        if _failover:
            if self._dead is not None or self._draining or self._stop:
                return None
            with self._cv:
                entry = (request, _handle)
                self._queue.append(entry)
                _metrics.set_gauge("serving.queue_depth", len(self._queue))
                self._ensure_thread()
                self._cv.notify_all()
            if (self._dead is not None or self._draining or self._stop) \
                    and self._unqueue(entry):
                return None     # died/drained between check and append
            return _handle
        if _probe and (self._dead is not None or self._draining
                       or self._stop):
            return None
        fid = _trace.new_flow()
        handle = RequestHandle(request, flow_id=fid)
        _metrics.inc("serving.requests")
        if self._dead:
            return shed_handle(handle, "engine_dead",
                               f"engine dead: {self._dead}")
        if self._draining:
            return shed_handle(handle, "draining", "engine draining")
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
            if self.queue_full():
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
        try:
            fault_point("serving.admit")
        except FaultInjected as e:
            return shed_handle(handle, "admit_fault", repr(e))
        _trace.flow_start("serving.request", fid, args={"uid": request.uid})
        with self._cv:
            entry = (request, handle)
            self._queue.append(entry)
            _metrics.set_gauge("serving.queue_depth", len(self._queue))
            self._ensure_thread()
            self._cv.notify_all()
        if (self._dead is not None or self._draining or self._stop) \
                and self._unqueue(entry):
            # the engine died/drained/stopped between the checks and the
            # append: the fail/drain snapshot missed this entry
            if _probe:
                return None
            reason = "engine_dead" if self._dead is not None \
                else "draining"
            return shed_handle(handle, reason,
                               f"engine {reason.replace('_', ' ')} during "
                               f"submit: {self._dead or 'draining'}")
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

    def queue_full(self) -> bool:
        """Whether a submit now would shed queue_full: the frontend's hint
        to prefer a replica with queue room (load is token-weighted, the
        queue bound counts entries)."""
        with self._cv:
            return len(self._queue) >= self.config.max_queue

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
        if self._draining:
            return      # a drain-racing submit must not revive the thread
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
        if self.prefix_cache is not None:
            # drop the cache-owned chain references so the shared-block
            # gauge returns to zero before the allocator retires
            self.prefix_cache.clear(self.cache.allocator)
        if self.spec is not None:
            self.spec.close()
        self.cache.close()   # retire this pool from the process gauges

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    def _service_loop(self):
        with torch.no_grad(), _on_stream(self.device, self._stream):
            while True:
                with self._cv:
                    # go on when there are slots to decode, a queue to
                    # admit (not while draining: a draining engine only
                    # runs its in-flight slots down) or a kill to honour
                    while (not self._stop and self._kill is None
                           and not self._slots
                           and (self._draining or not self._queue)):
                        self._cv.wait(0.05)
                    if self._stop:
                        break
                if self._kill is not None:
                    # a kill() lands here, between windows: the boundary a
                    # real window fault dies at, so the emitted-token
                    # counts the failover replay skips by are never taken
                    # mid-window
                    self._fail_all(self._kill)
                    break
                try:
                    self._admit()
                    if self._slots:
                        # speculative rounds replace plain windows while
                        # the draft is armed; a dead draft degrades to
                        # plain decode (spec-on tokens == spec-off tokens)
                        if self.spec is not None and self.spec.armed:
                            self.spec.run_round()
                        else:
                            self._run_window()
                except Exception as e:  # noqa: BLE001 — fail requests, die
                    # the thread's boundary: every waiter gets a terminal
                    # completion (or a failover) carrying the traceback
                    self._fail_all(f"{e!r}\n{traceback.format_exc()}")
                    break

    def kill(self, why: str):
        """Kill the engine from any thread. With the service thread
        running, death is deferred to its next window boundary, so it
        never races the in-flight window's slot accounting; otherwise it
        is immediate."""
        with self._cv:
            t = self._thread
            if (t is not None and t.is_alive()
                    and t is not threading.current_thread()):
                self._kill = why
                self._cv.notify_all()
                return
        self._fail_all(why)

    def _fail_all(self, why: str):
        """The engine is dead. With a frontend's failover sink installed,
        the queued and in-flight requests (each handle carrying the tokens
        streamed so far) are handed to it for re-dispatch; the
        deterministic decode makes the replay bit for bit. Without one
        (a standalone engine) every request fails typed."""
        self._dead = why
        self._died_at = time.perf_counter()
        # SUSPECT when a frontend watches (its health tick confirms DEAD);
        # a standalone engine goes straight to DEAD: nobody resurrects it
        self._set_health(Health.SUSPECT if self._failover is not None
                         else Health.DEAD)
        _metrics.inc("serving.engine_failures")
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            slots = dict(self._slots)
            self._slots.clear()
            _metrics.set_gauge("serving.queue_depth", 0)
        for idx in slots:
            self.cache.release(idx)
        if self.spec is not None:
            self.spec.release_all()
        victims = list(pending)
        victims += [(slot.handle.request, slot.handle)
                    for slot in slots.values()]
        sink = self._failover
        if sink is not None:
            sink(self, victims, why)
            return
        for _, handle in victims:
            handle._finish(RequestState.FAILED, "engine failed", error=why)

    # ---- drain + resurrection -------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> List[tuple]:
        """Graceful drain: stop admitting, finish the in-flight slots, hand
        back the never-served queue as [(Request, RequestHandle)].
        Handed-back handles finish `shed:draining`; the Requests are the
        caller's to re-route. A queued failover victim that already
        streamed tokens is not handed back: it fails typed
        (RequestFailedError), because "shed" promises the request was
        never served. Stops the engine afterwards; `timeout_s` (default
        FLAGS_serving_drain_timeout_ms) bounds the whole call, the
        service-thread join included."""
        if timeout_s is None:
            timeout_s = float(flag("FLAGS_serving_drain_timeout_ms")) \
                / 1000.0
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                # a request mid-admission (popped, not yet slotted) is
                # in-flight work too
                busy = bool(self._slots) or self._admitting is not None
            t = self._thread
            if (not busy or self._dead is not None
                    or t is None or not t.is_alive()):
                break
            time.sleep(0.01)
        with self._cv:
            queued = list(self._queue)
            self._queue.clear()
            _metrics.set_gauge("serving.queue_depth", 0)
        unstarted = []
        for req, handle in queued:
            if handle.tokens_so_far():
                handle._finish(
                    RequestState.FAILED, "drained mid-failover",
                    error="engine drained while the request awaited its "
                          "failover re-decode (tokens already streamed)")
            else:
                unstarted.append((req, handle))
                shed_handle(handle, "draining", "engine drained")
        self.stop(join_timeout_s=max(deadline - time.monotonic(), 0.2))
        return unstarted

    def _await_quiet(self, timeout_s: Optional[float] = None):
        """Wait, bounded, until nothing of the dead engine still runs: its
        service thread has exited and the window a watchdog trip abandoned
        has returned and completed on the device (its static buffers and
        pools are free to write). Raises Unavailable otherwise, which the
        frontend's RetryPolicy retries."""
        if timeout_s is None:
            timeout_s = _QUIET_TIMEOUT_S
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout_s)
            if t.is_alive():
                raise _errors.Unavailable(
                    "engine %d: its service thread has not exited",
                    self._id)
        w = self._abandoned
        if w is not None:
            if not w.quiet(timeout_s):
                raise _errors.Unavailable(
                    "engine %d: the call a watchdog trip abandoned is "
                    "still running", self._id)
            self._abandoned = None

    def resurrect(self) -> "DecodeEngine":
        """Reset the dead engine in place and clear its death; the caller
        (ServingFrontend's health loop) gates its rejoin on a canary.

        First waits, bounded, for the dead engine's service thread and
        for a window abandoned by a watchdog trip (`_await_quiet`; raises
        Unavailable if they are still running). Then, on the engine's
        stream, zeroes the pools and the static input buffers in place
        and starts a fresh allocator, page table and prefix cache. The
        captured graphs are KEPT: they hold the pools' and buffers'
        addresses, which do not move, so nothing is captured while other
        replicas serve (the counterpart of the reference's window jit
        surviving). The draft arm is reset the same way.

        Resurrection covers host-side deaths only: an injected fault, a
        watchdog trip, a Python exception. A sticky CUDA error (an illegal
        address) poisons the whole context; no reset recovers from it."""
        self._set_health(Health.RESURRECTING)
        _metrics.inc("serving.resurrections")
        self._await_quiet()
        with self._cv:
            self._queue.clear()
            self._slots.clear()
            self._admitting = None
        with _on_stream(self.device, self._stream):
            self.cache.reset()
            for t in self._static.values():
                t.zero_()
            if self.prefix_cache is not None:
                # cached chains pointed into the pool just zeroed
                self.prefix_cache = RadixPrefixCache(self.config.block_size)
            if self.spec is not None:
                self.spec.reset()
        self._dead = None
        self._kill = None
        self._draining = False
        self._stop = False
        return self

    # ---- admission -------------------------------------------------------
    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        return self.buckets[-1]

    def _assign_evicting(self, slot_idx: int,
                         n_blocks: int) -> Optional[List[int]]:
        """cache.assign with one eviction retry: idle refcount-1 prefix
        chains are reclaimable pool space, so admission pressure evicts
        them LRU-first before parking the FCFS head."""
        blocks = self.cache.assign(slot_idx, n_blocks)
        if blocks is None and self.prefix_cache is not None:
            need = n_blocks - self.cache.allocator.free_blocks
            if self.prefix_cache.evict(self.cache.allocator, need) > 0:
                blocks = self.cache.assign(slot_idx, n_blocks)
        return blocks

    def _fund(self, slot_idx: int, req: Request, plen: int):
        """Fund the head request's blocks, all-or-nothing. Returns
        (blocks, matched_prefix_tokens, cow_src_block | None), or None if
        the pool cannot fund it (the request stays queued, FCFS).

        Cold path: the full `_block_budget` (the formula submit's
        unfundable shed uses). Prefix path: look up the longest cached
        prefix, pin the whole chain, map its full blocks read-only into
        the slot row and fund only the rest of the chain. A partially
        filled tail block stays OUT of the row (the suffix prefill copies
        its rows into the slot's first private block) and stays pinned
        until the prefill lands. Either path may evict LRU refcount-1
        chains; the pin keeps the retry from recycling the chain just
        matched."""
        bs = self.config.block_size
        n_cold = self._block_budget(plen, req.max_new_tokens)
        if self.prefix_cache is None:
            blocks = self.cache.assign(slot_idx, n_cold)
            return None if blocks is None else (blocks, 0, None)
        alloc = self.cache.allocator
        chain, matched = self.prefix_cache.lookup(req.prompt)
        if not matched:
            blocks = self._assign_evicting(slot_idx, n_cold)
            return None if blocks is None else (blocks, 0, None)
        alloc.share(chain)                       # pin across eviction
        nf = matched // bs
        shared = chain[:nf]
        cow_src = chain[-1] if matched % bs else None
        n_private = -(-(plen + req.max_new_tokens) // bs) - nf
        private = self.cache.assign_with_prefix(slot_idx, shared,
                                                n_private)
        if private is None:
            self.prefix_cache.evict(alloc, n_private - alloc.free_blocks)
            private = self.cache.assign_with_prefix(slot_idx, shared,
                                                    n_private)
        if private is None:
            alloc.free(chain)                    # unpin, stay queued
            return None
        alloc.free(shared)   # the row holds its own refs; cow_src pinned
        return self.cache.blocks_of(slot_idx), matched, cow_src

    def _admit(self):
        while True:
            with self._cv:
                if not self._queue or self._draining:
                    return
                entry = self._queue[0]
                req, handle = entry
            free = [i for i in range(self.config.max_slots)
                    if i not in self._slots]
            if not free:
                return
            plen = int(req.prompt.shape[0])
            slot_idx = free[0]
            funding = self._fund(slot_idx, req, plen)
            if funding is None:
                # FCFS: wait for a retirement to free blocks rather than
                # starving big requests behind small ones
                return
            blocks, matched, cow_src = funding
            with self._cv:
                # re-verify the head: a concurrent stop() may have claimed
                # the entry while the lock was released
                head_claimed = not self._queue or self._queue[0] is not entry
                if not head_claimed:
                    self._queue.pop(0)
                    # visible to drain()'s busy check while the entry is
                    # neither queued nor slotted (the whole prefill)
                    self._admitting = entry
                    _metrics.set_gauge("serving.queue_depth",
                                       len(self._queue))
            if head_claimed:
                self.cache.release(slot_idx)
                if cow_src is not None:
                    self.cache.allocator.free([cow_src])   # drop the pin
                return
            if self.prefix_cache is not None:
                if matched:
                    self._prefix_hits += 1
                    self._prefill_tokens_saved += matched
                    _metrics.inc("serving.prefix_cache.hits")
                    _metrics.inc("serving.prefill_tokens_saved", matched)
                else:
                    self._prefix_misses += 1
                    _metrics.inc("serving.prefix_cache.misses")
            if handle.failovers == 0:    # re-dispatches would skew it
                _metrics.observe(
                    "serving.queue_wait_ms",
                    (time.perf_counter() - handle.t_submit) * 1000.0)
            try:
                self._prefill_into(slot_idx, blocks, req, handle, plen,
                                   matched, cow_src)
            except Exception as e:  # noqa: BLE001 — isolate to the request
                # a per-request admission failure fails THAT request, not
                # the engine and everything in flight. With a failover
                # sink the victim is re-dispatched instead, charged to its
                # failover budget (a request that always fails its
                # prefill must not ping-pong between replicas forever)
                if self.cache.blocks_of(slot_idx):
                    self.cache.release(slot_idx)
                with self._cv:
                    self._slots.pop(slot_idx, None)
                _metrics.inc("serving.prefill_failures")
                sink = self._failover
                if sink is not None:
                    sink(self, [(req, handle)], f"prefill failed: {e!r}",
                         charge_unserved=True)
                else:
                    handle._finish(RequestState.FAILED, "prefill failed",
                                   error=f"{e!r}\n{traceback.format_exc()}")
            finally:
                with self._cv:
                    self._admitting = None

    def _prefill_into(self, slot_idx, blocks, req, handle, plen,
                      matched=0, cow_src=None):
        fault_point("serving.prefill")
        handle._set_state(RequestState.PREFILL)
        _trace.instant("serving.admit",
                       args={"uid": req.uid, "slot": slot_idx})
        _metrics.inc("serving.prefills")
        try:
            if matched:
                first = self._suffix_prefill(slot_idx, req, plen, matched,
                                             cow_src)
            else:
                first = self._cold_prefill(req, plen, blocks)
        finally:
            if cow_src is not None:
                # drop the CoW-source pin (_fund): the private copy is
                # written; the radix cache keeps its own reference
                self.cache.allocator.free([cow_src])
        # TTFT is measured at HOST materialization of the first token
        with _trace.RecordEvent("fetch.materialize",
                                args={"name": "serving.first_token"}):
            tok = int(first)
        handle._append_tokens([tok])
        handle._set_state(RequestState.DECODE)
        if not handle._ttft_observed:   # a failover replay is not a TTFT
            handle._ttft_observed = True
            _metrics.observe("serving.ttft_ms", handle.ttft_ms())
        _trace.instant("serving.first_token", args={"uid": req.uid})
        eos = -1 if req.eos_token is None else int(req.eos_token)
        if req.max_new_tokens == 1 or tok == eos:
            self._publish_prefix(slot_idx, req)
            self.cache.release(slot_idx)
            self._retire(handle, "eos" if tok == eos else "length")
            return
        with self._cv:    # load()/stats() iterate _slots cross-thread
            self._slots[slot_idx] = _Slot(
                handle, pos=plen, gen=1, token=tok, eos=eos,
                max_new=req.max_new_tokens, temp=float(req.temperature),
                top_k=int(req.top_k), seed=int(req.seed))
        _metrics.set_gauge("serving.active_slots", len(self._slots))
        if self.spec is not None:
            # mapped/reserve split (cache.py): keep only the blocks that
            # hold prompt positions in the row; the rest of the budget
            # waits in the reserve so a rejected round can truncate back
            self.cache.reserve_tail(slot_idx,
                                    -(-plen // self.config.block_size))
            self.spec.on_admit(slot_idx, req, plen, tok)

    def _cold_prefill(self, req, plen, blocks):
        """Prefill every chunk of the prompt and write its positions into
        the slot's first blocks."""
        with _trace.RecordEvent("serving.prefill",
                                args={"uid": req.uid,
                                      "chunk": self.prefill_chunk}):
            k_seq, v_seq, first = self._prefill_fn(
                req.prompt, plen, float(req.temperature), int(req.top_k),
                int(req.seed))
            self._write_fn(k_seq, v_seq,
                           blocks[:-(-plen // self.config.block_size)], 0,
                           plen)
        return first

    def _suffix_prefill(self, slot_idx, req, plen, matched, cow_src):
        """Prefill only the chunks a prefix-cache hit does not cover. The
        cached chain (the shared full blocks in the slot's row, then the
        pinned partial tail `cow_src`) is gathered from the pool into the
        k/v buffers' first `matched` columns (position-indexed: column j
        is position j). The write starts at the tail block: its rows below
        `matched` are copied out of the gather into the slot's private
        block (copy-on-write), so a shared block is never written."""
        bs = self.config.block_size
        row = self.cache.blocks_of(slot_idx)
        nf = matched // bs
        chain = row[:nf] + ([int(cow_src)] if matched % bs else [])
        idx = torch.as_tensor(chain, dtype=torch.long, device=self.device)
        L, nh = self.model_config.num_layers, self.model_config.num_heads
        hd = self.cache.config.head_dim

        def gather(pool):
            g = pool[:, idx].permute(0, 2, 1, 3, 4)   # [L, nh, n, bs, hd]
            return g.reshape(L, nh, len(chain) * bs, hd)[:, :, :matched]

        with _trace.RecordEvent("serving.suffix_prefill",
                                args={"uid": req.uid, "matched": matched}):
            k_seq, v_seq, first = self._prefill_fn(
                req.prompt, plen, float(req.temperature), int(req.top_k),
                int(req.seed), prefix_kv=(gather(self.cache.k_pool),
                                          gather(self.cache.v_pool)),
                matched=matched)
            self._write_fn(k_seq, v_seq, row[nf:-(-plen // bs)], nf * bs,
                           plen)
        return first

    def _publish_prefix(self, slot_idx: int, req: Request):
        """Publish a retiring slot's prompt chain into the radix cache. The
        cache takes its own block references (insert -> share), so the
        chain survives the release that follows."""
        if self.prefix_cache is None:
            return
        blocks = self.cache.blocks_of(slot_idx)
        if blocks:
            self.prefix_cache.insert(req.prompt, blocks,
                                     self.cache.allocator)

    def _retire(self, handle, reason: str):
        handle._finish(RequestState.DONE, reason)
        self._completed += 1
        _metrics.inc("serving.completed")
        tpot = handle.tpot_ms()
        if tpot is not None:
            _metrics.observe("serving.tpot_ms", tpot)
        if handle.flow_id is not None:
            _trace.flow_end("serving.request", handle.flow_id,
                            args={"uid": handle.request.uid,
                                  "reason": reason})

    # ---- decode window ---------------------------------------------------
    def _slot_arrays(self, slots=None) -> Dict[str, np.ndarray]:
        """The per-slot inputs of a window or verify call, as host arrays
        (dtypes are the static buffers'), from `slots` (default: this
        engine's) and this engine's page table."""
        B = self.config.max_slots
        a = {"page_table": self.cache.page_table_rows(B),
             "tokens": np.zeros((B,), np.int64),
             "pos": np.zeros((B,), np.int32),
             "gen": np.zeros((B,), np.int32),
             "live": np.zeros((B,), bool),
             "eos": np.full((B,), -1, np.int64),
             "max_new": np.full((B,), 1, np.int32),
             "temps": np.zeros((B,), np.float32),
             "top_ks": np.zeros((B,), np.int64),
             "seeds": np.zeros((B,), np.int64)}
        for i, s in (self._slots if slots is None else slots).items():
            a["tokens"][i], a["pos"][i], a["gen"][i] = s.token, s.pos, s.gen
            a["live"][i], a["temps"][i] = True, s.temp
            a["top_ks"][i], a["seeds"][i] = s.top_k, fold_seed(s.seed)
            a["eos"][i], a["max_new"][i] = s.eos, s.max_new
        return a

    def _window_tokens(self, host: Dict[str, np.ndarray]):
        """One window over `host`'s inputs -> (tokens, active) [W, B] host
        arrays, with no envelope: the draft arm's proposal (serving/spec.py)
        runs inside the target's round."""
        toks, acts = self._call("window", self._window_eager, host)
        return toks.cpu().numpy(), acts.cpu().numpy()

    def _run_window(self):
        # the chaos-drill kill site: an injected error here escalates
        # through the service loop to _fail_all, the path a real window
        # fault takes, before the flight step opens
        fault_point("serving.window")
        self._windows += 1
        _metrics.inc("serving.windows")
        if self.spec is not None:
            # degraded spec engine: the mapped row may lag the reserve
            # split, so map every position this window can write
            bs = self.config.block_size
            for idx, s in list(self._slots.items()):
                last = s.pos + min(self.config.window, s.max_new - s.gen) - 1
                self.cache.extend_mapped(idx, last // bs + 1)
        host = self._slot_arrays()
        t0 = time.perf_counter()
        toks, acts = self._watched("window", self._window_eager, host,
                                   "serving.window", "serving.window_tokens")
        self._observe_window(t0)
        self._apply_window(toks, acts)

    def _observe_window(self, t0: float):
        window_ms = (time.perf_counter() - t0) * 1000.0
        _metrics.observe("serving.window_ms", window_ms)
        # EWMA of window wall time: the queue-wait estimator's clock
        self._window_ms_ewma = (
            window_ms if self._window_ms_ewma is None
            else 0.8 * self._window_ms_ewma + 0.2 * window_ms)

    def _apply_slot_tokens(self, idx: int, slot: _Slot, tokens) -> tuple:
        """Host-side walk of one slot's emitted tokens (eos/length
        truncation), shared by the plain window and the speculative verify
        round. Appends to the handle, retires the slot when it finishes.
        Returns (n_emitted, finish_reason | None)."""
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
            self._publish_prefix(idx, slot.handle.request)
            self.cache.release(idx)
            with self._cv:    # load()/stats() iterate cross-thread
                self._slots.pop(idx, None)
            if self.spec is not None:
                self.spec.on_release(idx)
            self._retire(slot.handle, finished)
        return len(emitted), finished

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
            n_tokens += self._apply_slot_tokens(idx, slot, run)[0]
        _metrics.inc("serving.tokens_out", n_tokens)
        _metrics.set_gauge("serving.active_slots", len(self._slots))

    # ---- speculative verify round (serving/spec.py drives this) ---------
    def _run_verify(self, cand: np.ndarray, valid: np.ndarray):
        """One verify pass over `cand` [B, span] (valid [B, span]): the
        captured `_verify_eager` on a CUDA engine. Returns (vtok [B, span],
        n_acc [B]) as host arrays; SpecDecoder.run_round applies them. The
        envelope is the window's: the same fault site (a kill lands at the
        same boundary whether speculation is armed or not), flight step,
        watchdog and EWMA clock."""
        fault_point("serving.window")
        self._windows += 1
        _metrics.inc("serving.windows")
        host = self._slot_arrays()
        for k in ("tokens", "eos", "max_new"):
            del host[k]
        host["cand"] = cand.astype(np.int64)
        host["valid"] = valid.astype(bool)
        t0 = time.perf_counter()
        vtok, n_acc = self._watched("verify", self._verify_eager, host,
                                    "serving.spec_verify",
                                    "serving.verify_tokens")
        self._observe_window(t0)
        return vtok, n_acc

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        row = {
            "windows": self._windows,
            "completed": self._completed,
            "active_slots": len(self._slots),
            "queued": len(self._queue),
            "free_blocks": self.cache.allocator.free_blocks,
            "dead": self._dead,
            "health": self.health,
            "load": self.load(),
            "graphs": len(self._graphs),
            "graph_replays": self._replays,
            "eager_calls": self._eager_calls,
            "kernel_launches_window": self._graph_launches["window"],
            "kernel_launches_verify": self._graph_launches["verify"],
        }
        if self.prefix_cache is not None:
            looked = self._prefix_hits + self._prefix_misses
            row.update({
                "prefix_cache_nodes": len(self.prefix_cache),
                "prefix_cache_hits": self._prefix_hits,
                "prefix_cache_misses": self._prefix_misses,
                "prefix_cache_hit_rate": (
                    self._prefix_hits / looked if looked else 0.0),
                "prefill_tokens_saved": self._prefill_tokens_saved,
                "shared_blocks": self.cache.allocator.shared_blocks,
            })
        if self.spec is not None:
            row.update(self.spec.stats())
        return row

