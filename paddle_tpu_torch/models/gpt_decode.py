"""KV-cache autoregressive decoding for GPT (counterpart of
paddle_tpu/models/gpt_decode.py).

The decode path re-expresses the ops the static graph trains
(fc = x @ w + b, pre-LN eps 1e-5, exact erf gelu, tied head) as plain
PyTorch on tensors:

* `prefill` is one dense causal forward over the whole prompt;
* `decode_step` writes one position into a dense per-layer
  [B, nh, max_len, hd] cache IN PLACE and attends against it;
* `generate` is a Python loop over `decode_step` (the reference compiles
  one `lax.scan`).

Weights come from numpy arrays named as the scope names them
(`params_from_numpy`) or straight from a scope the port trained
(`params_from_scope`).

`_block` is the single transformer-block body prefill, dense decode and
the paged serving window (serving/engine.py) all run through; its `merge`
hook keeps the reference's contract, including the attend override the
paged kernel path uses.

Sampling (`sample_rows`): each draw is a pure function of (seed,
generated index). The Gumbel noise is a counter hash of (seed, index,
vocab column) computed from device tensors, so a request's tokens do not
depend on which slot, window or batch carries it, and the draw can be
captured in a CUDA graph. JAX's `fold_in` stream cannot be reproduced
here, so seeded sampling matches the reference in distribution only.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..framework.errors import NotFoundError
from .gpt import GPTConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """"float32" / "bfloat16" (or a torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def param_names(cfg: GPTConfig):
    names = ["wte", "wpe", "final_ln_scale", "final_ln_bias"]
    for i in range(cfg.num_layers):
        names += [f"dec{i}_ln1_scale", f"dec{i}_ln1_bias",
                  f"dec{i}_attn_qkv_w", f"dec{i}_attn_qkv_b",
                  f"dec{i}_attn_proj_w", f"dec{i}_attn_proj_b",
                  f"dec{i}_ln2_scale", f"dec{i}_ln2_bias",
                  f"dec{i}_ffn_in_w", f"dec{i}_ffn_in_b",
                  f"dec{i}_ffn_out_w", f"dec{i}_ffn_out_b"]
    return names


def params_from_numpy(cfg: GPTConfig, arrays: Mapping[str, np.ndarray],
                      dtype=None, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The GPT parameter set as tensors on `device`, from numpy arrays named
    as the reference's scope names them (the counterpart of
    `params_from_scope`). fc weights are [in, out] (x @ w + b).

    dtype="bfloat16" casts float params once at load; layernorm scales and
    biases stay f32 (`_ln` computes in f32)."""
    dev = resolve_device(device)
    cast = None if dtype is None else as_dtype(dtype)
    params = {}
    for n in param_names(cfg):
        if n not in arrays:
            raise NotFoundError(f"parameter {n!r} not in the given arrays",
                                var=n)
        t = torch.tensor(np.asarray(arrays[n]))    # a copy
        if cast is not None and "_ln" not in n and t.is_floating_point():
            t = t.to(cast)
        params[n] = t.to(dev)
    return params


def params_from_scope(cfg: GPTConfig, scope=None, dtype=None,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The GPT parameter set pulled out of a (trained) scope by name, as
    copies on `device` (reference gpt_decode.py:38): a model the port's
    Executor trained through models.gpt.build_lm_program serves from
    here. dtype="bfloat16" casts float params once; layernorm scales and
    biases stay f32."""
    if scope is None:
        from ..framework.scope import global_scope
        scope = global_scope()
    dev = resolve_device(device)
    cast = None if dtype is None else as_dtype(dtype)
    params = {}
    for n in param_names(cfg):
        v = scope.find(n)
        if v is None:
            raise NotFoundError(
                f"parameter {n!r} not found in scope: build the model with "
                "models.gpt.gpt_decoder and run the startup program first",
                var=n)
        t = torch.as_tensor(v).detach().to(dev, copy=True)
        if cast is not None and "_ln" not in n and t.is_floating_point():
            t = t.to(cast)
        params[n] = t
    return params


def _ln(x, scale, bias, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _split_heads(t, nh):
    b, s, h = t.shape
    return t.reshape(b, s, nh, h // nh).transpose(1, 2)


def _merge_heads(t):
    b, nh, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, nh * hd)


def _attend(q, k, v, mask, scale):
    # q: [B, nh, Sq, hd]; k/v: [B, nh, Sk, hd]; mask additive [.., Sq, Sk].
    # Scores accumulate in f32 (bf16 products are exact in f32); the
    # probabilities are cast to the value dtype before the context product.
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _mm(a, w):
    """a @ w with jnp's type promotion, as the reference's `@` computes
    it: an f32 activation against bf16 weights (the int8 arm, whose f32
    biases make its activations f32) is an f32 product of the exact bf16
    values."""
    if a.dtype != w.dtype:
        dt = torch.promote_types(a.dtype, w.dtype)
        a, w = a.to(dt), w.to(dt)
    return a @ w


def _block_qkv(x, p, i, cfg):
    """The first half of a decoder block: pre-LN and the qkv projection,
    split into heads. -> (q, k, v), each [B, nh, S, hd]."""
    nh, h = cfg.num_heads, cfg.hidden_size
    a = _ln(x, p[f"dec{i}_ln1_scale"], p[f"dec{i}_ln1_bias"])
    qkv = _mm(a, p[f"dec{i}_attn_qkv_w"]) + p[f"dec{i}_attn_qkv_b"]
    q, k, v = torch.split(qkv, h, dim=-1)
    return _split_heads(q, nh), _split_heads(k, nh), _split_heads(v, nh)


def _block_out(x, ctx, p, i):
    """The second half: the attention context [B, nh, S, hd] through the
    output projection and the residual, then the pre-LN FFN. Every sum and
    product promotes as in the reference (an f32 int8-pool context makes
    the residual stream f32 from there on)."""
    proj = _mm(_merge_heads(ctx), p[f"dec{i}_attn_proj_w"]) \
        + p[f"dec{i}_attn_proj_b"]
    x = x + proj
    f = _ln(x, p[f"dec{i}_ln2_scale"], p[f"dec{i}_ln2_bias"])
    ffn = F.gelu(_mm(f, p[f"dec{i}_ffn_in_w"]) + p[f"dec{i}_ffn_in_b"])
    ffn = _mm(ffn, p[f"dec{i}_ffn_out_w"]) + p[f"dec{i}_ffn_out_b"]
    return x + ffn


def _block(x, p, i, cfg, mask, merge=None):
    """One pre-LN decoder block, the single body prefill and cached decode
    run through (`_block_qkv`, attention, `_block_out`; the serving
    verify pass calls the two halves itself).

    merge(k_new, v_new) -> (k, v) maps this call's freshly projected
    keys/values to the pair attention runs against: prefill passes None;
    dense decode writes the new position into its cache and returns it. A
    merge may instead return a CALLABLE attend override ctx_fn(q) -> ctx —
    the paged decode path uses this to attend straight off the block pool
    (`mask` is then the override's responsibility). Returns
    (x_out, (k, v)) with the attended pair (the fresh pair under an
    override)."""
    hd = cfg.hidden_size // cfg.num_heads
    q, k_new, v_new = _block_qkv(x, p, i, cfg)
    merged = (k_new, v_new) if merge is None else merge(k_new, v_new)
    if callable(merged):
        k, v = k_new, v_new
        ctx = merged(q)
    else:
        k, v = merged
        ctx = _attend(q, k, v, mask, 1.0 / math.sqrt(hd))
    return _block_out(x, ctx, p, i), (k, v)


def _embed(p, tokens, pos_start: int):
    # tokens [B, S] -> [B, S, H] with positions pos_start..pos_start+S-1
    s = tokens.shape[1]
    return p["wte"][tokens] + p["wpe"][pos_start:pos_start + s][None]


def _logits(x, p):
    """Tied head with f32 accumulation: [B, S, H] -> [B, S, V] f32."""
    return torch.matmul(x.float(), p["wte"].float().t())


_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two xorshift-multiply rounds, multiplier
    0x45d9f3b) on int64 tensors holding values in [0, 2**32). Products stay
    below 2**59, so no int64 arithmetic overflows on any device."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def fold_seed(seed: int) -> int:
    """A request seed (any Python int) folded to the 32 bits the sampler
    hashes."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s ^ (s >> 32)) & _M32


def gumbel_noise(seeds: torch.Tensor, index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel noise [B, vocab] f32 from a counter hash of (seed, generated
    index, vocab column): row b is a pure function of (seeds[b],
    index[b]). seeds: [B] int64 (`fold_seed`-ed); index: [B] int64. Only
    device tensor ops, so the draw can sit inside a captured CUDA graph."""
    key = _hash32(seeds ^ _hash32(index + 0x9E3779B9))
    col = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _hash32(key[:, None] ^ _hash32(col * 0x2545F491)[None, :])
    # 24 random bits -> u in (0, 1), never 0 or 1
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_rows(logits, temps, top_ks, seeds, index):
    """One vectorised sampling rule per row: greedy where temps == 0, else
    temperature, a per-row top-k (the k-th value of one descending sort;
    0 = no cut, k > vocab = all) and Gumbel-max with the (seed, index)
    noise. logits [B, V]; temps [B] f32, top_ks / seeds / index [B] int64,
    all on the logits' device. Returns [B] int64."""
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(top_ks, 1, v) - 1
    kth = torch.gather(srt, 1, k[:, None])
    filtered = scaled.masked_fill(scaled < kth, float("-inf"))
    use = torch.where((top_ks > 0)[:, None], filtered, scaled)
    sampled = torch.argmax(use + gumbel_noise(seeds, index, v), dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def _sample(logits, temperature: float, top_k: int, seed: int = 0,
            index: int = 0):
    """`sample_rows` with one (temperature, top_k, seed, index) for every
    row. logits [B, V] -> [B] int64."""
    b = logits.shape[0]
    dev = logits.device

    def full(value, dtype):
        return torch.full((b,), value, dtype=dtype, device=dev)

    return sample_rows(logits, full(float(temperature), torch.float32),
                       full(int(top_k), torch.int64),
                       full(fold_seed(seed), torch.int64),
                       full(int(index), torch.int64))


def prefill(params, cfg: GPTConfig, prompt, prompt_len: int, max_len: int):
    """Dense causal forward over the padded prompt; returns
    (cache_k, cache_v, last_logits). prompt is [B, Sp] (padded), with
    prompt_len <= Sp real tokens; cache_* are per-layer lists of
    [B, nh, max_len, hd] holding positions < prompt_len (pad positions
    zeroed). Decode resumes at pos = prompt_len."""
    b, sp = prompt.shape
    dev = prompt.device
    x = _embed(params, prompt, 0)
    idx = torch.arange(sp, device=dev)
    causal = torch.zeros((sp, sp), dtype=torch.float32, device=dev)
    causal = causal.masked_fill(idx[:, None] < idx[None, :], float("-inf"))
    keep = (torch.arange(max_len, device=dev) < prompt_len)[None, None, :,
                                                           None]
    cache_k, cache_v = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block(x, params, i, cfg, causal)
        pad = (0, 0, 0, max_len - sp)
        cache_k.append(torch.where(keep, F.pad(k, pad), 0).to(k.dtype))
        cache_v.append(torch.where(keep, F.pad(v, pad), 0).to(v.dtype))
    x = _ln(x, params["final_ln_scale"], params["final_ln_bias"])
    # slice the last real position BEFORE the [H, V] head matmul
    last = _logits(x[:, prompt_len - 1:prompt_len], params)[:, 0]
    return cache_k, cache_v, last


def decode_step(params, cfg: GPTConfig, cache_k, cache_v, token, pos: int):
    """One cached decode step: token [B] at position pos. Writes the new
    position into cache_k/cache_v IN PLACE and returns
    (cache_k, cache_v, logits [B, V] f32)."""
    max_len = cache_k[0].shape[2]
    dev = token.device
    x = _embed(params, token[:, None], pos)
    # keys 0..pos are valid after this step's write
    mask = torch.zeros((1, max_len), dtype=torch.float32, device=dev)
    mask = mask.masked_fill(torch.arange(max_len, device=dev)[None] > pos,
                            float("-inf"))
    for i in range(cfg.num_layers):
        def merge(k1, v1, _i=i):
            # write-then-attend: this position's k/v into the cache,
            # attention runs against the merged cache
            cache_k[_i][:, :, pos:pos + 1] = k1.to(cache_k[_i].dtype)
            cache_v[_i][:, :, pos:pos + 1] = v1.to(cache_v[_i].dtype)
            return cache_k[_i], cache_v[_i]

        x, _ = _block(x, params, i, cfg, mask, merge)
    x = _ln(x, params["final_ln_scale"], params["final_ln_bias"])
    return cache_k, cache_v, _logits(x, params)[:, 0]


@torch.inference_mode()
def generate(params: Dict[str, torch.Tensor], cfg: GPTConfig, prompt_ids,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int = 0, seed: int = 0, eos_token: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """Autoregressive generation with a dense KV cache.

    prompt_ids: [B, Sp] int tokens (no padding — all rows same length).
    Returns [B, Sp + max_new_tokens] int64 on `device` (default cuda; the
    params must already live there). Greedy when temperature == 0; token
    t of the generation draws with noise (seed, t). When eos_token is set,
    rows that have emitted it keep emitting eos_token."""
    dev = resolve_device(device)
    if params["wte"].device.type != dev.type:
        raise ValueError(f"params live on {params['wte'].device}, "
                         f"generate was asked to run on {dev}")
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=dev)
    _, sp = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got "
                         f"{max_new_tokens}")
    if max_new_tokens == 0:
        return prompt
    if sp + max_new_tokens > cfg.max_position:
        raise ValueError(
            f"prompt {sp} + {max_new_tokens} new tokens exceeds "
            f"max_position {cfg.max_position}")
    ck, cv, logits = prefill(params, cfg, prompt, sp, sp + max_new_tokens)
    tok = _sample(logits, temperature, top_k, seed, 0)
    done = (tok == eos_token) if eos_token is not None \
        else torch.zeros_like(tok, dtype=torch.bool)
    out = [tok]
    for t in range(max_new_tokens - 1):
        ck, cv, logits = decode_step(params, cfg, ck, cv, tok, sp + t)
        nxt = _sample(logits, temperature, top_k, seed, t + 1)
        if eos_token is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
            done = done | (nxt == eos_token)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
