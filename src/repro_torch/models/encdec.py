"""Whisper-style encoder–decoder backbone (arXiv:2212.04356), as the
reference's ``repro/models/encdec.py``.

The conv/mel frontend is a stub: the inputs carry precomputed frame
embeddings [B, n_frames, D]. The encoder is bidirectional self-attention
with sinusoidal positions; the decoder is causal self-attention +
cross-attention with sinusoidal positions.

The decode cache carries the decoder's self-attention K/V and the encoder
output (``memory``); each step recomputes the cross-attention K/V over
``memory``, as the reference does. The reference builds its 65,536-row
position table on every decoder call; here it is built once per
model and device and sliced.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import shard_activation, zeros_placed

from . import common as C
from .common import ParamSpec
from .transformer import _cache_write, _f32_then_cast

# rows of the decoder's position table: the reference's 16 * 4096
MAX_POSITIONS = 16 * 4096


@dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int              # per stack (n enc + n dec)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500
    vocab_pad_to: int = 1

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    def param_count(self) -> int:
        D, F, L = self.d_model, self.d_ff, self.n_layers
        attn = 4 * D * D
        enc = L * (attn + 2 * D * F + 4 * D)
        dec = L * (2 * attn + 2 * D * F + 6 * D)
        return self.vocab * D * 2 + enc + dec + 2 * D

    def active_param_count(self) -> int:
        return self.param_count()


def _sinusoid(S: int, D: int, device="cpu") -> torch.Tensor:
    """[S, D] f32: sin of each position over 10000^(2i/D), then cos, as
    the reference's table comes out under ``jax.jit``: XLA turns the
    division by the broadcast power into a product with its f32
    reciprocal, and its f32 power is the f64 one rounded (torch's f32
    ``pow`` is an ulp off for some exponents, which moves row 65,535 by
    ~4e-3)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, D, 2, dtype=torch.float32, device=device)[None, :]
    power = torch.pow(10000.0, (dim / D).double()).float()
    ang = pos * (1.0 / power)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    def __init__(self, cfg: EncDecConfig, tp_divisor: int = 1,
                 q_chunk: int = 2048):
        self.cfg = cfg
        self.q_chunk = q_chunk
        self.H = C.pad_heads(cfg.n_heads, tp_divisor)
        self._tables = {}

    def position_table(self, device) -> torch.Tensor:
        """``_sinusoid(MAX_POSITIONS, d_model)`` on ``device``, built on
        first use (100 MB at d_model 384) and kept by the model."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = _sinusoid(MAX_POSITIONS, self.cfg.d_model,
                                          device)
        return self._tables[key]

    # ------------------------------------------------------------- params
    def _attn_specs(self):
        D, dh, H = self.cfg.d_model, self.cfg.dh, self.H
        return {
            "wq": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
            "wk": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
            "wv": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
            "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed")),
        }

    def _mlp_specs(self):
        c = self.cfg
        return {
            "wi": ParamSpec((c.d_model, c.d_ff), ("embed", "mlp")),
            "wo": ParamSpec((c.d_ff, c.d_model), ("mlp", "embed")),
        }

    def param_specs(self):
        c, D = self.cfg, self.cfg.d_model
        enc, dec = [], []
        for _ in range(c.n_layers):
            enc.append({"ln1": ParamSpec((D,), ("embed",), init="ones"),
                        "ln2": ParamSpec((D,), ("embed",), init="ones"),
                        "attn": self._attn_specs(), "mlp": self._mlp_specs()})
            dec.append({"ln1": ParamSpec((D,), ("embed",), init="ones"),
                        "ln2": ParamSpec((D,), ("embed",), init="ones"),
                        "ln3": ParamSpec((D,), ("embed",), init="ones"),
                        "self_attn": self._attn_specs(),
                        "cross_attn": self._attn_specs(),
                        "mlp": self._mlp_specs()})
        return {
            "embed": ParamSpec((c.padded_vocab, D), ("vocab", "embed")),
            "enc_layers": enc,
            "dec_layers": dec,
            "ln_enc": ParamSpec((D,), ("embed",), init="ones"),
            "ln_dec": ParamSpec((D,), ("embed",), init="ones"),
            "lm_head": ParamSpec((D, c.padded_vocab), ("embed", "vocab")),
        }

    # ------------------------------------------------------------ blocks
    def _proj_qkv(self, p, xq, xkv):
        D, dh = self.cfg.d_model, self.cfg.dh

        def proj(x, w):
            return _f32_then_cast(x, w.reshape(D, -1).to(xq.dtype)).reshape(
                *x.shape[:2], self.H, dh)
        return proj(xq, p["wq"]), proj(xkv, p["wk"]), proj(xkv, p["wv"])

    def _out(self, p, o, dtype):
        return C.einsum("bshk,hkd->bsd", o, p["wo"].to(dtype))

    def _mlp(self, p, x):
        h = C.matmul_f32(x, p["wi"].to(x.dtype))
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh").to(x.dtype)
        return h @ p["wo"].to(x.dtype)

    # ----------------------------------------------------------- encoder
    def encode(self, params, frames):
        """frames [B, n_frames, D] (stubbed frontend output)."""
        x = frames.to(C.COMPUTE_DTYPE)
        S = x.shape[1]
        x = x + self.position_table(x.device)[:S].to(x.dtype)[None]
        for lp in params["enc_layers"]:
            lp = C.gather_weights(lp)
            h = C.rms_norm(x, lp["ln1"])
            q, k, v = self._proj_qkv(lp["attn"], h, h)
            o = C.dense_attention(q, k, v, causal=False, q_chunk=self.q_chunk)
            x = x + self._out(lp["attn"], o, x.dtype)
            x = x + self._mlp(lp["mlp"], C.rms_norm(x, lp["ln2"]))
            x = shard_activation(x, ("batch", "seq_save", None))
        return C.rms_norm(x, C.gather_weights(params["ln_enc"]))

    # ----------------------------------------------------------- decoder
    def _decoder(self, params, x, memory, caches=None, cache_len=0):
        new_caches = []
        S = x.shape[1]
        pe = self.position_table(x.device)
        x = x + pe[cache_len:cache_len + S][None].to(x.dtype)
        for i, lp in enumerate(params["dec_layers"]):
            lp = C.gather_weights(lp)
            h = C.rms_norm(x, lp["ln1"])
            q, k, v = self._proj_qkv(lp["self_attn"], h, h)
            if caches is None:
                o = C.dense_attention(q, k, v, causal=True,
                                      q_chunk=self.q_chunk)
                nc = None
            else:
                ck = _cache_write(caches[i]["k"], k, cache_len)
                cv = _cache_write(caches[i]["v"], v, cache_len)
                nc = {"k": ck, "v": cv}
                o = C.dense_attention(q, ck, cv, causal=True,
                                      q_chunk=self.q_chunk, q_offset=cache_len,
                                      kv_valid_len=cache_len + S)
            x = x + self._out(lp["self_attn"], o, x.dtype)
            # cross attention over encoder memory (never cached/causal)
            h = C.rms_norm(x, lp["ln2"])
            q, k, v = self._proj_qkv(lp["cross_attn"], h, memory)
            o = C.dense_attention(q, k, v, causal=False, q_chunk=self.q_chunk)
            x = x + self._out(lp["cross_attn"], o, x.dtype)
            x = x + self._mlp(lp["mlp"], C.rms_norm(x, lp["ln3"]))
            x = shard_activation(x, ("batch", "seq_save", None))
            new_caches.append(nc)
        return C.rms_norm(x, C.gather_weights(params["ln_dec"])), new_caches

    def _logits(self, params, x):
        lg = C.matmul_f32(x, C.gather_weights(params["lm_head"]).to(x.dtype))
        lg = shard_activation(lg, ("batch", "seq", "vocab"))
        c = self.cfg
        if c.padded_vocab != c.vocab:
            pad = torch.arange(c.padded_vocab, device=lg.device) >= c.vocab
            lg = lg.masked_fill(pad[None, None], -1e30)
        return lg

    # -------------------------------------------------------------- entry
    def loss(self, params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        memory = self.encode(params, batch["frames"])
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, _ = self._decoder(params, x, memory)
        return C.softmax_xent(self._logits(params, x), labels,
                              batch.get("loss_mask"))

    def prefill(self, params, batch, max_len: int):
        tokens = batch["tokens"]
        B, S = tokens.shape
        memory = self.encode(params, batch["frames"])
        caches = zeros_placed(lambda d: self.empty_caches(B, max_len, device=d),
                              self.cache_axes()["layers"], tokens.device)
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._decoder(params, x, memory, caches=caches,
                                  cache_len=0)
        return self._logits(params, x[:, -1:]), {
            "layers": caches, "memory": memory, "len": S}

    def decode_step(self, params, cache, tokens):
        """tokens [B,1]; ``cache['len']`` is a host int."""
        ln = cache["len"]
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._decoder(params, x, cache["memory"],
                                  caches=cache["layers"], cache_len=ln)
        return self._logits(params, x), {"layers": caches,
                                         "memory": cache["memory"],
                                         "len": ln + 1}

    # -------------------------------------------------------------- cache
    def empty_caches(self, B, S, device="cuda"):
        shape = (B, S, self.H, self.cfg.dh)
        return [{"k": torch.zeros(shape, dtype=C.COMPUTE_DTYPE, device=device),
                 "v": torch.zeros(shape, dtype=C.COMPUTE_DTYPE, device=device)}
                for _ in range(self.cfg.n_layers)]

    def cache_specs(self, B, S):
        """The decode cache's shapes and dtypes as ``meta`` tensors."""
        c = self.cfg
        return {"layers": self.empty_caches(B, S, device="meta"),
                "memory": torch.empty((B, c.n_frames, c.d_model),
                                      dtype=C.COMPUTE_DTYPE, device="meta"),
                "len": torch.empty((), dtype=torch.int32, device="meta")}

    def cache_axes(self):
        """The logical axes of each ``cache_specs`` leaf."""
        layer = {"k": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim"),
                 "v": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim")}
        return {"layers": [layer for _ in range(self.cfg.n_layers)],
                "memory": ("batch", "frames", None), "len": ()}

    def param_count(self):
        return self.cfg.param_count()

    def active_param_count(self):
        return self.cfg.active_param_count()
