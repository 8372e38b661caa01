"""Decoder-only transformer LM covering the dense/GQA/MLA/MoE archs of the
reference's ``repro/models/transformer.py`` (deepseek-67b/7b,
llama3.2-1b, qwen3-14b, llama4-scout, deepseek-v2-lite, and the text
backbone of internvl2).

Layers are unrolled; ``loss`` (train), ``prefill`` and ``decode_step``
(serve) share one parameter tree with the reference's keys and shapes.
Plain functions of a params dict, eager torch: the reference's einsums
become torch matmuls on the same dtypes, the KV cache update stays
functional (a new cache tensor per step, as ``dynamic_update_slice``
returns), and the cache length is a host int. ``remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``, the reference's
per-layer ``jax.checkpoint``): the same values, one layer's activations
alive at a time. Scanned layers are refused (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.ctx import shard_activation, zeros_placed

from . import common as C
from .common import ParamSpec


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 5e5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # attention masking
    sliding_window: int = 0           # 0 = full causal
    vocab_pad_to: int = 1             # pad vocab to a multiple (TP divisibility)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.first_k_dense

    def param_count(self) -> int:
        """Total parameters (for 6ND roofline accounting)."""
        c, D, dh = self, self.d_model, self.dh
        n = c.vocab * D * 2                      # embed + head
        for i in range(c.n_layers):
            n += 2 * D                           # norms
            if c.mla:
                n += D * c.n_heads * (c.qk_nope_dim + c.qk_rope_dim)
                n += D * (c.kv_lora_rank + c.qk_rope_dim) + c.kv_lora_rank
                n += c.kv_lora_rank * c.n_heads * (c.qk_nope_dim + c.v_head_dim)
                n += c.n_heads * c.v_head_dim * D
            else:
                n += D * c.n_heads * dh + 2 * D * c.n_kv_heads * dh + c.n_heads * dh * D
            if c.is_moe_layer(i):
                n += D * c.n_experts + 3 * c.n_experts * D * c.moe_d_ff
                n += 3 * D * c.moe_d_ff * c.n_shared_experts
            else:
                n += 3 * D * c.d_ff
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        c, D = self, self.d_model
        n = self.param_count()
        for i in range(c.n_layers):
            if c.is_moe_layer(i):
                n -= 3 * (c.n_experts - c.top_k) * D * c.moe_d_ff
        return n


def _f32_then_cast(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w [K, N], or [E, K, N] beside x [E, M, K]) summed in f32
    and rounded to x's dtype: the reference's
    ``einsum(..., preferred_element_type=jnp.float32).astype(x.dtype)``."""
    return C.matmul_f32(x, w.to(x.dtype)).to(x.dtype)


def _per_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,K], w [H,K,N] -> [B,S,H,N]: one product a head, summed in
    f32 and rounded to x's dtype."""
    B, S, H, K = x.shape
    y = _f32_then_cast(x.permute(2, 0, 1, 3).reshape(H, B * S, K), w)
    return y.reshape(H, B, S, -1).permute(1, 2, 0, 3)


def _latent_scores(q, c):
    """MLA's absorbed scores: q [B,S,H,r], c [B,Tc,r] -> [B,H,S,Tc] f32,
    the reference's ``einsum("bshr,btr->bhst",
    preferred_element_type=f32)`` as one batched product of the (h, s)
    rows (over a mesh, run on each rank's own heads by ``C.einsum``)."""
    B, S, H, r = q.shape
    s = C.matmul_f32(q.permute(0, 2, 1, 3).reshape(B, H * S, r),
                     c.transpose(1, 2))
    return s.reshape(B, H, S, c.shape[1])


def _latent_context(p, c):
    """p [B,H,S,Tc], c [B,Tc,r] -> [B,S,H,r] f32: the reference's
    ``einsum("bhst,btr->bshr", preferred_element_type=f32)``."""
    B, H, S, Tc = p.shape
    ctx = C.matmul_f32(p.reshape(B, H * S, Tc), c)
    return ctx.reshape(B, H, S, c.shape[2]).permute(0, 2, 1, 3)


def _cache_write(buf: torch.Tensor, new: torch.Tensor,
                 start: int) -> torch.Tensor:
    """A copy of the cache ``buf`` with ``new`` at ``start`` along the
    sequence axis. A write past the cache's length raises; the
    reference's ``dynamic_update_slice`` would clamp it."""
    return buf.slice_scatter(new, dim=1, start=start, end=start + new.shape[1])


class TransformerLM:
    """The decoder: dense, MoE (``n_experts > 0``, the first
    ``first_k_dense`` layers dense) and MLA (``mla=True``) layers.
    ``scan_layers`` is refused: eager torch has no compile time for a scan
    to save (ROADMAP.md, Queue 1 item 7)."""

    def __init__(self, cfg: TransformerConfig, tp_divisor: int = 1,
                 q_chunk: int = 4096, remat: bool = False,
                 scan_layers: bool = False):
        if scan_layers:
            raise NotImplementedError(
                "scan_layers=True is not ported to repro_torch; see "
                "ROADMAP.md, Queue 1 item 7")
        self.cfg = cfg
        self.q_chunk = q_chunk
        self.remat = remat                                  # per-layer rematerialization
        self.H = C.pad_heads(cfg.n_heads, tp_divisor)      # padded q/o heads
        self.Hkv = cfg.n_kv_heads                           # never padded

    # ------------------------------------------------------------- params
    def _layer_specs_one(self, moe: bool):
        c, D, dh, H = self.cfg, self.cfg.d_model, self.cfg.dh, self.H
        p = {
            "ln1": ParamSpec((D,), ("embed",), init="ones"),
            "ln2": ParamSpec((D,), ("embed",), init="ones"),
        }
        if c.mla:
            p["attn"] = {
                "wq": ParamSpec((D, H, c.qk_nope_dim + c.qk_rope_dim),
                                ("embed", "heads", "head_dim")),
                "wkv_a": ParamSpec((D, c.kv_lora_rank + c.qk_rope_dim),
                                   ("embed", "kv_lora")),
                "kv_norm": ParamSpec((c.kv_lora_rank,), ("kv_lora",), init="ones"),
                "wk_b": ParamSpec((c.kv_lora_rank, H, c.qk_nope_dim),
                                  ("kv_lora", "heads", "head_dim")),
                "wv_b": ParamSpec((c.kv_lora_rank, H, c.v_head_dim),
                                  ("kv_lora", "heads", "head_dim")),
                "wo": ParamSpec((H, c.v_head_dim, D),
                                ("heads", "head_dim", "embed")),
            }
        else:
            p["attn"] = {
                "wq": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
                "wk": ParamSpec((D, self.Hkv, dh), ("embed", "kv_heads", "head_dim")),
                "wv": ParamSpec((D, self.Hkv, dh), ("embed", "kv_heads", "head_dim")),
                "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed")),
            }
            if c.qk_norm:
                p["attn"]["q_norm"] = ParamSpec((dh,), ("head_dim",), init="ones")
                p["attn"]["k_norm"] = ParamSpec((dh,), ("head_dim",), init="ones")
        if moe:
            p["moe"] = C.moe_param_specs(D, c.moe_d_ff, c.n_experts)
            if c.n_shared_experts:
                p["shared_mlp"] = C.swiglu_param_specs(
                    D, c.moe_d_ff * c.n_shared_experts)
        else:
            p["mlp"] = C.swiglu_param_specs(D, c.d_ff)
        return p

    def param_specs(self):
        c = self.cfg
        V = c.padded_vocab
        return {
            "embed": ParamSpec((V, c.d_model), ("vocab", "embed"), scale=1.0),
            "ln_f": ParamSpec((c.d_model,), ("embed",), init="ones"),
            "lm_head": ParamSpec((c.d_model, V), ("embed", "vocab")),
            "layers": [self._layer_specs_one(c.is_moe_layer(i))
                       for i in range(c.n_layers)],
        }

    # ------------------------------------------------------------ forward
    def _attn(self, p, x, *, positions, cache=None, cache_len=None):
        """x [B,S,D] -> [B,S,D]; if cache given (decode/prefill-write) the
        (k,v) for these positions are written at ``cache_len`` into a new
        cache (the one passed in is left as it was; ``_cache_write``)."""
        c, dh = self.cfg, self.cfg.dh
        B, S, D = x.shape
        if c.mla:
            return self._attn_mla(p, x, positions=positions, cache=cache,
                                  cache_len=cache_len)
        q = C.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
        k = C.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
        v = C.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
        if c.qk_norm:
            q = C.rms_norm(q, p["q_norm"])
            k = C.rms_norm(k, p["k_norm"])
        cos, sin = C.rope_tables(positions, dh, c.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = C.apply_rope(q, cos, sin)
        k = C.apply_rope(k, cos, sin)

        window = c.sliding_window or None
        if cache is None:
            o = C.dense_attention(q, k, v, causal=True, q_chunk=self.q_chunk,
                                  window=window)
        else:
            start = cache_len if cache_len is not None else 0
            ck = _cache_write(cache["k"], k, start)
            cv = _cache_write(cache["v"], v, start)
            cache = {"k": ck, "v": cv}
            o = C.dense_attention(q, ck, cv, causal=True, q_chunk=self.q_chunk,
                                  q_offset=start, window=window,
                                  kv_valid_len=start + S)
        y = C.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
        return y, cache

    def _attn_mla(self, p, x, *, positions, cache=None, cache_len=None):
        """Multi-head latent attention. Without a cache (the loss):
        materialized K/V. With one (prefill and decode): only the
        compressed latents ``ckv`` and ``krope`` are written to the cache,
        and the scores take the absorbed form over it (prefill too, as in
        the reference: it passes empty caches)."""
        c = self.cfg
        B, S, D = x.shape
        H = self.H
        r, nd, rd = c.kv_lora_rank, c.qk_nope_dim, c.qk_rope_dim
        q = _f32_then_cast(x, p["wq"].reshape(D, -1)).reshape(B, S, H, nd + rd)
        q_nope, q_rope = q[..., :nd], q[..., nd:]
        kv_a = _f32_then_cast(x, p["wkv_a"])
        ckv, k_rope = kv_a[..., :r], kv_a[..., r:]
        ckv = C.rms_norm(ckv, p["kv_norm"])
        cos, sin = C.rope_tables(positions, rd, c.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q_rope = C.apply_rope(q_rope, cos, sin)
        k_rope = C.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
        scale = 1.0 / math.sqrt(nd + rd)

        if cache is None:
            k_nope = _f32_then_cast(ckv, p["wk_b"].reshape(r, -1)).reshape(
                B, S, H, nd)
            v = _f32_then_cast(ckv, p["wv_b"].reshape(r, -1)).reshape(
                B, S, H, c.v_head_dim)
            kk = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)],
                           dim=-1)
            qq = torch.cat([q_nope, q_rope], dim=-1)
            o = C.dense_attention(qq * math.sqrt((nd + rd) / qq.shape[-1]),
                                  kk, v, causal=True, q_chunk=self.q_chunk)
            y = C.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
            return y, None

        start = cache_len
        cc = _cache_write(cache["ckv"], ckv, start)
        cr = _cache_write(cache["krope"], k_rope, start)
        cache = {"ckv": cc, "krope": cr}
        Tc = cc.shape[1]
        # absorbed scores: q_nope into the latent space once a step; the
        # heads stay a dim of their own (over a mesh, split on `model`)
        q_lat = _per_head(q_nope, p["wk_b"].permute(1, 2, 0))   # [B,S,H,r]
        s = (C.einsum("bshr,btr->bhst", q_lat, cc, local=_latent_scores)
             + C.einsum("bshr,btr->bhst", q_rope, cr, local=_latent_scores)
             ) * scale                                           # [B,H,S,Tc]
        kpos = torch.arange(Tc, device=x.device)
        qpos = start + torch.arange(S, device=x.device)
        s = s.masked_fill((kpos[None, :] > qpos[:, None])[None, None], -1e30)
        pattn = torch.softmax(s, dim=-1).to(x.dtype)
        ctx = C.einsum("bhst,btr->bshr", pattn, cc,
                       local=_latent_context).to(x.dtype)        # [B,S,H,r]
        o = _per_head(ctx, p["wv_b"].permute(1, 0, 2))           # [B,S,H,vd]
        y = C.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
        return y, cache

    def _mlp(self, lp, moe: bool, x):
        c = self.cfg
        if moe:
            y = C.moe_block(x, lp["moe"], n_experts=c.n_experts, top_k=c.top_k)
            if c.n_shared_experts:
                y = y + C.swiglu(x, lp["shared_mlp"]["wi_gate"],
                                 lp["shared_mlp"]["wi_up"],
                                 lp["shared_mlp"]["wo"])
            return y
        return C.swiglu(x, lp["mlp"]["wi_gate"], lp["mlp"]["wi_up"],
                        lp["mlp"]["wo"])

    def _layer_apply(self, lp, x, moe: bool, *, positions, cache, cache_len):
        """One transformer block -> (x, new_cache). Megatron-SP
        discipline: the layer-boundary activations are sequence-sharded
        where the rules map ``seq_save`` to a mesh axis. Over a mesh the
        layer's weights are gathered on the data-parallel axes here, so
        one layer's whole weights are alive at a time (and, under remat,
        gathered again in the backward)."""
        lp = C.gather_weights(lp)
        x = shard_activation(x, ("batch", "seq", None))
        h, nc = self._attn(lp["attn"], C.rms_norm(x, lp["ln1"]),
                           positions=positions, cache=cache,
                           cache_len=cache_len)
        x = x + h
        x = x + self._mlp(lp, moe, C.rms_norm(x, lp["ln2"]))
        x = shard_activation(x, ("batch", "seq_save", None))
        return x, nc

    def _backbone(self, params, x, *, positions, caches=None, cache_len=None):
        new_caches = []
        for i, lp in enumerate(params["layers"]):
            moe = self.cfg.is_moe_layer(i)
            if caches is None and self.remat:
                def f(lp, x, moe=moe):
                    return self._layer_apply(lp, x, moe, positions=positions,
                                             cache=None, cache_len=None)[0]
                x = checkpoint(f, lp, x, use_reentrant=False)
                new_caches.append(None)
                continue
            x, nc = self._layer_apply(
                lp, x, moe, positions=positions,
                cache=None if caches is None else caches[i],
                cache_len=cache_len)
            new_caches.append(nc)
        return x, new_caches

    def _embed(self, params, tokens):
        return C.embed_lookup(C.gather_weights(params["embed"]), tokens)

    def _final_norm(self, params, x):
        return C.rms_norm(x, C.gather_weights(params["ln_f"]))

    def _logits(self, params, x):
        w = C.gather_weights(params["lm_head"])
        lg = C.matmul_f32(x, w.to(x.dtype))
        lg = shard_activation(lg, ("batch", "seq", "vocab"))
        c = self.cfg
        if c.padded_vocab != c.vocab:
            pad = torch.arange(c.padded_vocab, device=lg.device) >= c.vocab
            lg = lg.masked_fill(pad[None, None], -1e30)
        return lg

    # -------------------------------------------------------------- entry
    def loss(self, params, batch):
        """batch {'tokens', 'labels': [B,S] int, optional 'loss_mask'} ->
        the mean next-token cross entropy (f32 scalar)."""
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        x = self._embed(params, tokens)
        x, _ = self._backbone(params, x, positions=pos)
        x = self._final_norm(params, x)
        return C.softmax_xent(self._logits(params, x), labels,
                              batch.get("loss_mask"))

    def prefill(self, params, batch, max_len: int):
        """batch {'tokens': [B,S] int} -> (logits [B,1,V] f32 of the last
        position, cache {'layers': [...], 'len': S})."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        caches = zeros_placed(lambda d: self.empty_caches(B, max_len, device=d),
                              self.cache_axes()["layers"], tokens.device)
        x = self._embed(params, tokens)
        x, caches = self._backbone(params, x, positions=pos, caches=caches,
                                   cache_len=0)
        x = self._final_norm(params, x)
        logits = self._logits(params, x[:, -1:])
        return logits, {"layers": caches, "len": S}

    def decode_step(self, params, cache, tokens):
        """tokens [B,1] -> (logits [B,1,V], cache). ``cache['len']`` is a
        host int: no device value is read back per layer."""
        B = tokens.shape[0]
        ln = cache["len"]
        pos = torch.full((B, 1), ln, device=tokens.device)
        x = self._embed(params, tokens)
        x, caches = self._backbone(params, x, positions=pos,
                                   caches=cache["layers"], cache_len=ln)
        x = self._final_norm(params, x)
        return self._logits(params, x), {"layers": caches, "len": ln + 1}

    # -------------------------------------------------------------- cache
    def _empty_cache_layer(self, B, S, device):
        c = self.cfg
        if c.mla:
            shapes = {"ckv": (B, S, c.kv_lora_rank),
                      "krope": (B, S, c.qk_rope_dim)}
        else:
            shapes = {"k": (B, S, self.Hkv, c.dh), "v": (B, S, self.Hkv, c.dh)}
        return {k: torch.zeros(shape, dtype=C.COMPUTE_DTYPE, device=device)
                for k, shape in shapes.items()}

    def empty_caches(self, B, S, device="cuda"):
        return [self._empty_cache_layer(B, S, device)
                for _ in range(self.cfg.n_layers)]

    def cache_specs(self, B, S):
        """The decode cache's shapes and dtypes as ``meta`` tensors (no
        memory): the reference's ``jax.eval_shape`` stand-in."""
        return {"layers": self.empty_caches(B, S, device="meta"),
                "len": torch.empty((), dtype=torch.int32, device="meta")}

    def cache_axes(self):
        """The logical axes of each ``cache_specs`` leaf (layers unrolled)."""
        if self.cfg.mla:
            layer = {"ckv": ("batch", "seq_kv", "kv_cache_lora"),
                     "krope": ("batch", "seq_kv", None)}
        else:
            layer = {"k": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim"),
                     "v": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim")}
        return {"layers": [layer for _ in range(self.cfg.n_layers)], "len": ()}

    # ----------------------------------------------------------- counting
    def param_count(self):
        return self.cfg.param_count()

    def active_param_count(self):
        return self.cfg.active_param_count()
