"""RWKV6 "Finch" (arXiv:2404.05892), an attention-free LM backbone, as the
reference's ``repro/models/rwkv6.py``.

Time mixing: per-head matrix state S ∈ R^{dk×dv}, data-dependent per-channel
decay w_t (a low-rank LoRA on the decay), bonus u for the current token:

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u ⊙ k_t) v_tᵀ)

The recurrence is evaluated in chunks, a Python loop over them carrying the
f32 state (the reference's ``lax.scan``). With clw the inclusive cumsum of
log w over a chunk and clw_prev the exclusive one, the intra-chunk scores
are

    A[t,s] = Σ_d r_t,d k_s,d e^{clw_prev[t,d] − clw[s,d]},   s < t,

formed from the exponent difference, which is ≤ 0 where s < t (the
exponent is masked to −inf elsewhere before ``exp``), so every factor is at
most 1. The reference forms them as (r ⊙ e^{clw_prev − clw_L}) ·
(k ⊙ e^{clw_L − clw}); its first exponent is ≥ 0 and overflows once a
chunk's log-decays sum below ~−88 (ROADMAP.md, Queue 3). The cross-chunk
term r ⊙ e^{clw_prev} and the state update k ⊙ e^{clw_L − clw} are bounded
and stay as the reference has them.

Channel mixing: token-shift lerp + squared-ReLU MLP with a sigmoid gate.
Layers are unrolled and ``cache["len"]`` is a host int. ``scan_layers`` is
refused. ``remat`` recomputes each layer in the loss's backward
(``torch.utils.checkpoint``), the unrolled form of the reference's remat
of its scanned layers (the FULL cells scan, ``remat=True``); inside a
layer each chunk of the scan is recomputed too, so its backward holds one
chunk's [B,T,T,H,dh] decays at a time. Prefill and decode run as without
it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.ctx import shard_activation, zeros_placed

from . import common as C
from .common import ParamSpec
from .transformer import _f32_then_cast


@dataclass(frozen=True)
class RWKV6Config:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    decay_lora: int = 64
    vocab_pad_to: int = 1

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    def param_count(self) -> int:
        D, F = self.d_model, self.d_ff
        per_layer = 5 * D * D + 2 * D * self.decay_lora + (2 * D * F + D * D) + 8 * D
        return 2 * self.vocab * D + self.n_layers * per_layer

    def active_param_count(self) -> int:
        return self.param_count()


def _wkv_chunk(r_, k_, v_, lw_, u, state, earlier):
    """One chunk of ``_chunk_wkv``: r_, k_, v_, lw_ [B,T,H,dh] f32, u
    [1,1,H,dh], state [B,H,dh,dh] f32, ``earlier`` the [1,T,T,1,1] mask of
    s < t. Returns (y [B,T,H,dh], the state after the chunk)."""
    clw = torch.cumsum(lw_, dim=1)                          # inclusive
    clw_prev = clw - lw_                                    # exclusive
    clw_L = clw[:, -1:]                                     # [B,1,H,dh]
    # intra-chunk scores from the exponent difference, masked before exp
    gap = clw_prev[:, :, None] - clw[:, None, :]            # [B,T,T,H,dh]
    decay = torch.exp(gap.masked_fill(~earlier, float("-inf")))
    A = torch.einsum("bthd,btshd,bshd->bhts", r_, decay, k_)
    diag = torch.einsum("bthd,bthd->bth", r_, u * k_)
    y = torch.einsum("bhts,bshd->bthd", A, v_)
    y = y + diag[..., None] * v_
    # cross-chunk: r̃_t = r_t ⊙ e^{clw_prev}
    y = y + torch.einsum("bthk,bhkv->bthv", r_ * torch.exp(clw_prev), state)
    # state update: S1 = e^{clw_L} ⊙_k S0 + k̂ᵀ V, k̂ = k ⊙ e^{clw_L - clw}
    k_hat = k_ * torch.exp(clw_L - clw)
    state = torch.exp(clw_L)[:, 0, :, :, None] * state + torch.einsum(
        "bthk,bthv->bhkv", k_hat, v_)
    return y, state


def _chunk_wkv(r, k, v, lw, u, state0, chunk: int, recompute: bool = False):
    """Chunked RWKV6 recurrence.

    r,k,v: [B,S,H,dh] (dk == dv == dh), lw: [B,S,H,dh] log-decays (< 0),
    u: [H,dh] bonus, state0: [B,H,dh,dh] f32. Returns (y [B,S,H,dh] f32,
    state [B,H,dh,dh]). S must be a multiple of ``min(chunk, S)``. Each
    chunk holds a [B,T,T,H,dh] transient of pairwise decays; with
    ``recompute`` each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), so the backward holds one chunk's
    transients at a time, with the same values.
    """
    B, S, H, dh = r.shape
    T = min(chunk, S)
    n = S // T
    assert S % T == 0, f"seq {S} not divisible by chunk {T}"
    rc, kc, vc, lwc = (t.reshape(B, n, T, H, dh).float()
                       for t in (r, k, v, lw))
    earlier = torch.tril(torch.ones(T, T, dtype=torch.bool, device=r.device),
                         diagonal=-1)[None, :, :, None, None]    # s < t
    u = u.float()[None, None]
    step = (functools.partial(checkpoint, _wkv_chunk, use_reentrant=False)
            if recompute else _wkv_chunk)

    state = state0.float()
    ys = []
    for i in range(n):
        y, state = step(rc[:, i], kc[:, i], vc[:, i], lwc[:, i], u, state,
                        earlier)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, dh), state


def _token_shift(x, last):
    """x [B,S,D]; last [B,D] (previous token of the stream, zeros at start).
    Returns x shifted right by one along S."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


class RWKV6LM:
    def __init__(self, cfg: RWKV6Config, chunk: int = 64,
                 scan_layers: bool = False, remat: bool = False):
        if scan_layers:
            raise NotImplementedError(
                "scan_layers=True is not ported to repro_torch; see "
                "ROADMAP.md, Queue 1 item 7")
        self.cfg = cfg
        self.chunk = chunk
        self.remat = remat                      # per-layer rematerialization

    # ------------------------------------------------------------- params
    def _layer_specs_one(self):
        c, D, F = self.cfg, self.cfg.d_model, self.cfg.d_ff
        H, dh, L = c.n_heads, c.head_dim, c.decay_lora
        return {
            "ln1": ParamSpec((D,), ("embed",), init="ones"),
            "ln2": ParamSpec((D,), ("embed",), init="ones"),
            "time": {
                "mu_r": ParamSpec((D,), ("embed",), init="zeros"),
                "mu_k": ParamSpec((D,), ("embed",), init="zeros"),
                "mu_v": ParamSpec((D,), ("embed",), init="zeros"),
                "mu_g": ParamSpec((D,), ("embed",), init="zeros"),
                "mu_w": ParamSpec((D,), ("embed",), init="zeros"),
                "wr": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
                "wk": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
                "wv": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
                "wg": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
                "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed")),
                # data-dependent decay: w = w0 + tanh(x A) B  (Finch LoRA)
                "w0": ParamSpec((H, dh), ("heads", "head_dim"), init="zeros"),
                "wa": ParamSpec((D, L), ("embed", None), scale=0.1),
                "wb": ParamSpec((L, H, dh), (None, "heads", "head_dim"), scale=0.1),
                "u": ParamSpec((H, dh), ("heads", "head_dim"), init="zeros"),
                "ln_x": ParamSpec((H * dh,), ("embed",), init="ones"),
            },
            "chan": {
                "mu_k": ParamSpec((D,), ("embed",), init="zeros"),
                "mu_r": ParamSpec((D,), ("embed",), init="zeros"),
                "wk": ParamSpec((D, F), ("embed", "mlp")),
                "wv": ParamSpec((F, D), ("mlp", "embed")),
                "wr": ParamSpec((D, D), ("embed", "ssm_inner")),
            },
        }

    def param_specs(self):
        c = self.cfg
        V = c.padded_vocab
        return {
            "embed": ParamSpec((V, c.d_model), ("vocab", "embed")),
            "layers": [self._layer_specs_one() for _ in range(c.n_layers)],
            "ln_f": ParamSpec((c.d_model,), ("embed",), init="ones"),
            "lm_head": ParamSpec((c.d_model, V), ("embed", "vocab")),
        }

    # ------------------------------------------------------------ mixing
    def _log_decay(self, tp, xw):
        """xw [B,S,D] -> log w ∈ (-inf, 0): w = exp(-exp(w0 + lora))."""
        B, S, _ = xw.shape
        lora = C.matmul_f32(xw, tp["wa"].to(xw.dtype))
        lora = C.matmul_f32(torch.tanh(lora).to(xw.dtype),
                            tp["wb"].reshape(tp["wb"].shape[0], -1).to(
                                xw.dtype))
        raw = tp["w0"][None, None].float() + lora.reshape(
            B, S, *tp["w0"].shape).float()
        return -torch.exp(torch.clamp(raw, -8.0, 4.0)) - 1e-6   # strictly < 0

    def _time_mix(self, tp, x, last_x, state0, recompute=False):
        """x [B,S,D] -> (y [B,S,D], new_last_x [B,D], state). With
        ``recompute`` the scan recomputes each chunk in the backward."""
        c = self.cfg
        B, S, D = x.shape
        H, dh = c.n_heads, c.head_dim
        xx = _token_shift(x, last_x)

        def lerp(mu):
            return x + (xx - x) * mu[None, None].to(x.dtype)
        xr, xk, xv, xg, xw = (lerp(tp[k]) for k in ("mu_r", "mu_k", "mu_v",
                                                    "mu_g", "mu_w"))

        def proj(t, w):
            return _f32_then_cast(t, w.reshape(D, -1)).reshape(B, S, H, dh)
        r, k, v, g = (proj(xr, tp["wr"]), proj(xk, tp["wk"]),
                      proj(xv, tp["wv"]), proj(xg, tp["wg"]))
        lw = self._log_decay(tp, xw)                        # [B,S,H,dh] f32
        # on DTensors each rank runs the chunks of its own rows and heads
        # (the cumsum's backward is a flipped cumsum, which DTensor does
        # not shard on every torch)
        y, state = C.by_rows_and_heads(
            _chunk_wkv,
            (r, k, v, lw, tp["u"], state0, self.chunk, recompute),
            ((0, 2),) * 4 + ((None, 0), (0, 1), None, None),
            ((0, 2), (0, 1)))
        # per-head group norm then output proj
        yf = C.rms_norm(y.reshape(B, S, H * dh).to(x.dtype), tp["ln_x"])
        y = yf.reshape(B, S, H, dh) * F.silu(g.float()).to(x.dtype)
        out = C.einsum("bshk,hkd->bsd", y, tp["wo"].to(x.dtype))
        return out, x[:, -1, :], state

    def _chan_mix(self, cp, x, last_x):
        xx = _token_shift(x, last_x)
        xk = x + (xx - x) * cp["mu_k"][None, None].to(x.dtype)
        xr = x + (xx - x) * cp["mu_r"][None, None].to(x.dtype)
        k = C.matmul_f32(xk, cp["wk"].to(x.dtype))
        k = torch.square(torch.relu(k)).to(x.dtype)
        # over a mesh each rank contracts its own `mlp` columns (a partial
        # sum); DTensor's own product gathered them in the backward
        kv = C.einsum("bsf,fd->bsd", k, cp["wv"].to(x.dtype))
        r = C.matmul_f32(xr, cp["wr"].to(x.dtype))
        return torch.sigmoid(r).to(x.dtype) * kv, x[:, -1, :]

    # ------------------------------------------------------------ forward
    def _zero_cache(self, B, dtype, device):
        c = self.cfg
        return {"xt": torch.zeros((B, c.d_model), dtype=dtype, device=device),
                "xc": torch.zeros((B, c.d_model), dtype=dtype, device=device),
                "s": torch.zeros((B, c.n_heads, c.head_dim, c.head_dim),
                                 dtype=torch.float32, device=device)}

    def _layer_apply(self, lp, x, cache, recompute=False):
        """One layer and the boundary constraints (over a mesh, its weights
        gathered on the data-parallel axes, and its input whole on the
        sequence, as the transformer's layer takes it: a sequence split
        left by the ``seq_save`` boundary would otherwise name the
        projections' split and gather their head-split weights, so every
        ``model`` rank would scan all heads)."""
        lp = C.gather_weights(lp)
        x = shard_activation(x, ("batch", "seq", None))
        h, nxt, s1 = self._time_mix(lp["time"], C.rms_norm(x, lp["ln1"]),
                                    cache["xt"].to(x.dtype), cache["s"],
                                    recompute)
        x = x + h
        h, nxc = self._chan_mix(lp["chan"], C.rms_norm(x, lp["ln2"]),
                                cache["xc"].to(x.dtype))
        x = shard_activation(x + h, ("batch", "seq_save", None))
        return x, {"xt": nxt, "xc": nxc, "s": s1}

    def _backbone(self, params, x, caches=None):
        B = x.shape[0]
        new_caches = []
        for i, lp in enumerate(params["layers"]):
            if caches is None and self.remat:
                def f(lp, x):
                    zero = self._zero_cache(B, x.dtype, x.device)
                    return self._layer_apply(lp, x, zero, recompute=True)[0]
                x = checkpoint(f, lp, x, use_reentrant=False)
                new_caches.append(None)
                continue
            cache = (self._zero_cache(B, x.dtype, x.device) if caches is None
                     else caches[i])
            x, nc = self._layer_apply(lp, x, cache)
            new_caches.append(nc)
        return x, new_caches

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
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, _ = self._backbone(params, x)
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        return C.softmax_xent(self._logits(params, x), labels,
                              batch.get("loss_mask"))

    def init_caches(self, B, dtype=None, device="cuda"):
        dtype = dtype or C.COMPUTE_DTYPE
        return [self._zero_cache(B, dtype, device)
                for _ in range(self.cfg.n_layers)]

    def prefill(self, params, batch, max_len: int):
        tokens = batch["tokens"]
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._backbone(params, x, caches=zeros_placed(
            lambda d: self.init_caches(tokens.shape[0], device=d),
            self.cache_axes()["layers"], tokens.device))
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        logits = self._logits(params, x[:, -1:])
        return logits, {"layers": caches, "len": tokens.shape[1]}

    def decode_step(self, params, cache, tokens):
        """tokens [B,1]. State recurrence — O(1) in context length."""
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._backbone(params, x, caches=cache["layers"])
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        return self._logits(params, x), {"layers": caches,
                                         "len": cache["len"] + 1}

    # -------------------------------------------------------------- cache
    def cache_specs(self, B, S):
        """``meta`` tensors of the decode cache. S (the context length)
        does not appear: the state is of constant size."""
        return {"layers": self.init_caches(B, device="meta"),
                "len": torch.empty((), dtype=torch.int32, device="meta")}

    def cache_axes(self):
        """The logical axes of each ``cache_specs`` leaf (layers unrolled)."""
        layer = {"xt": ("batch", None), "xc": ("batch", None),
                 "s": ("batch", "heads", None, None)}
        return {"layers": [layer for _ in range(self.cfg.n_layers)], "len": ()}

    def param_count(self):
        return self.cfg.param_count()

    def active_param_count(self):
        return self.cfg.active_param_count()
