"""Mamba2 (SSD) layers and the Zamba2 hybrid backbone (arXiv:2411.15242),
as the reference's ``repro/models/ssm.py``.

Mamba2 state-space duality with scalar-per-head decay a_t ∈ (0,1):

    S_t = a_t · S_{t-1} + dt_t · x_t b_tᵀ          S ∈ R^{H, dh, N}
    y_t = S_t c_t + D ⊙ x_t

Chunked (SSD) evaluation: scalar decay makes the intra-chunk score matrix
(C Bᵀ) ⊙ Γ with Γ[t,s] = exp(min(cla_t − cla_s, 0)) for s ≤ t, a masked
product; a Python loop over the chunks carries S in f32 (the reference's
``lax.scan``). Every decay exponent is ≤ 0, so nothing overflows.

Zamba2: a stack of Mamba2 blocks with ONE shared transformer block (GQA
attention + SwiGLU, parameters shared) applied after every
``shared_every``-th layer. The shared attention uses a sliding window, and
its decode cache is a ring of ``min(max_len, attn_window)`` slots.

Layers are unrolled and ``cache["len"]`` is a host int. ``scan_layers``
is refused, as ``TransformerLM`` refuses it. ``remat`` recomputes each
Mamba2 layer and each application of the shared block in the loss's
backward (``torch.utils.checkpoint``), the unrolled form of the
reference's remat of its scanned groups (the FULL cells scan,
``remat=True``). Prefill and decode run as without it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.ctx import is_dtensor, shard_activation, zeros_placed

from . import common as C
from .common import ParamSpec
from .transformer import _cache_write, _f32_then_cast


@dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    d_ff: int                    # shared-block MLP width (zamba2)
    vocab: int
    ssm_state: int = 64          # N
    head_dim: int = 64           # dh
    expand: int = 2
    conv_width: int = 4
    # zamba2 shared attention block
    shared_every: int = 6        # 0 = pure mamba
    n_heads: int = 32
    n_kv_heads: int = 32
    attn_window: int = 4096
    rope_theta: float = 1e4
    vocab_pad_to: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def dh_attn(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        c, D, Di, N, H = self, self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        per = D * (2 * Di + 2 * N + H) + Di * D + 2 * H + Di + 2 * D  # in/out proj, A,D,dt_bias,norms
        per += c.conv_width * (Di + 2 * N)
        total = 2 * c.vocab * D + c.n_layers * per
        if c.shared_every:
            dh = c.dh_attn
            total += D * c.n_heads * dh + 2 * D * c.n_kv_heads * dh + c.n_heads * dh * D
            total += 3 * D * c.d_ff + 4 * D
        return total

    def active_param_count(self) -> int:
        return self.param_count()


def _ssd_chunk(xb, b, cmat, la, state0, chunk: int):
    """Chunked SSD scan.

    xb: [B,S,H,dh] (dt-scaled inputs), b,c: [B,S,N] (single group),
    la: [B,S,H] per-head log decay (≤ 0), state0: [B,H,dh,N] f32.
    Returns (y [B,S,H,dh] f32, state). S must be a multiple of
    ``min(chunk, S)``, as in the reference.
    """
    B, S, H, dh = xb.shape
    N = b.shape[-1]
    T = min(chunk, S)
    n = S // T
    assert S % T == 0
    xc = xb.reshape(B, n, T, H, dh).float()
    bc = b.reshape(B, n, T, N).float()
    cc = cmat.reshape(B, n, T, N).float()
    lac = la.reshape(B, n, T, H).float()
    tri = torch.tril(torch.ones(T, T, device=xb.device))     # inclusive diag

    state = state0.float()
    ys = []
    for i in range(n):
        x_, b_, c_, la_ = xc[:, i], bc[:, i], cc[:, i], lac[:, i]
        cla = torch.cumsum(la_, dim=1)                        # [B,T,H]
        cla_L = cla[:, -1:, :]
        # scores G[t,s] = (c_t·b_s) exp(cla_t - cla_s), s<=t
        scores = torch.einsum("btn,bsn->bts", c_, b_)
        gamma = torch.exp(torch.clamp(
            cla[:, :, None, :] - cla[:, None, :, :], max=0.0))
        A = scores[:, :, :, None] * gamma * tri[None, :, :, None]   # [B,T,T,H]
        y = torch.einsum("btsh,bshd->bthd", A, x_)
        # cross-chunk: y += (c_t ⊙ e^{cla_t}) · S0
        c_tld = c_[:, :, None, :] * torch.exp(cla)[..., None]      # [B,T,H,N]
        y = y + torch.einsum("bthn,bhdn->bthd", c_tld, state)
        # state: S1 = e^{cla_L} S0 + Σ_s e^{cla_L - cla_s} x_s b_sᵀ
        w = torch.exp(cla_L - cla)                                  # ≤ 1
        state = torch.exp(cla_L)[:, 0, :, None, None] * state + torch.einsum(
            "bthd,bth,btn->bhdn", x_, w, b_)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, dh), state


def _causal_conv(x, w, cache):
    """Depthwise causal conv. x [B,S,Ch], w [K,Ch], cache [B,K-1,Ch] or None.
    Returns (y [B,S,Ch], new_cache [B,K-1,Ch]). The K terms are summed in
    the reference's order, tap 0 first."""
    K = w.shape[0]
    S = x.shape[1]
    if cache is None:
        cache = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([cache, x], dim=1)
    y = xp[:, 0:S, :] * w[0][None, None].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * w[i][None, None].to(x.dtype)
    return y, xp[:, -(K - 1):, :] if K > 1 else cache


def _split_on_ranks(t) -> bool:
    """Whether ``t`` is a DTensor split over more than one rank on its
    last dim."""
    from torch.distributed.tensor import Shard
    return is_dtensor(t) and any(
        p == Shard(t.dim() - 1) and t.device_mesh.size(i) > 1
        for i, p in enumerate(t.placements))


def _split_last(t, sizes: list) -> tuple:
    """``torch.split(t, sizes, dim=-1)`` of a DTensor, gathered whole on
    its last dim first where it is split there (its shards do not fall
    at the parts' bounds)."""
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if p == Shard(t.dim() - 1) else p
            for p in t.placements]
    if want != list(t.placements):
        t = t.redistribute(t.device_mesh, want)
    return torch.split(t, sizes, dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) = logaddexp(x, 0) everywhere
    (torch's ``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Zamba2LM:
    """Mamba2 stack + shared attention block; pure Mamba2 if shared_every=0."""

    def __init__(self, cfg: Mamba2Config, chunk: int = 64, q_chunk: int = 2048,
                 scan_layers: bool = False, remat: bool = False):
        if scan_layers:
            raise NotImplementedError(
                "scan_layers=True is not ported to repro_torch; see "
                "ROADMAP.md, Queue 1 item 7")
        self.cfg = cfg
        self.chunk = chunk
        self.q_chunk = q_chunk
        self.remat = remat                      # per-layer rematerialization

    # ------------------------------------------------------------- params
    def param_specs(self):
        c, D, Di, N = self.cfg, self.cfg.d_model, self.cfg.d_inner, self.cfg.ssm_state
        H = c.ssm_heads
        one = {
            "ln": ParamSpec((D,), ("embed",), init="ones"),
            "in_proj": ParamSpec((D, 2 * Di + 2 * N + H), ("embed", "ssm_inner")),
            "conv_w": ParamSpec((c.conv_width, Di + 2 * N), ("conv", "ssm_inner"), scale=0.5),
            "a_log": ParamSpec((H,), (None,), init="zeros"),
            "d_skip": ParamSpec((H,), (None,), init="ones"),
            "dt_bias": ParamSpec((H,), (None,), init="zeros"),
            "norm_g": ParamSpec((Di,), ("ssm_inner",), init="ones"),
            "out_proj": ParamSpec((Di, D), ("ssm_inner", "embed")),
        }
        tree = {
            "embed": ParamSpec((c.padded_vocab, D), ("vocab", "embed")),
            "layers": [dict(one) for _ in range(c.n_layers)],
            "ln_f": ParamSpec((D,), ("embed",), init="ones"),
            "lm_head": ParamSpec((D, c.padded_vocab), ("embed", "vocab")),
        }
        if c.shared_every:
            dh = c.dh_attn
            tree["shared"] = {
                "ln1": ParamSpec((D,), ("embed",), init="ones"),
                "ln2": ParamSpec((D,), ("embed",), init="ones"),
                "attn": {
                    "wq": ParamSpec((D, c.n_heads, dh), ("embed", "heads", "head_dim")),
                    "wk": ParamSpec((D, c.n_kv_heads, dh), ("embed", "kv_heads", "head_dim")),
                    "wv": ParamSpec((D, c.n_kv_heads, dh), ("embed", "kv_heads", "head_dim")),
                    "wo": ParamSpec((c.n_heads, dh, D), ("heads", "head_dim", "embed")),
                },
                "mlp": C.swiglu_param_specs(D, c.d_ff),
            }
        return tree

    # -------------------------------------------------------- mamba block
    def _mamba(self, lp, x, conv_cache, state0):
        c = self.cfg
        B, S, D = x.shape
        Di, N, H, dh = c.d_inner, c.ssm_state, c.ssm_heads, c.head_dim
        if S > 1 and _split_on_ranks(lp["in_proj"]):
            z, xin, b, cm, dt, new_conv = self._mamba_in_parts(lp, x,
                                                               conv_cache)
        else:
            zxbcdt = _f32_then_cast(x, lp["in_proj"])
            z, xin, b, cm, dt = torch.split(zxbcdt, [Di, Di, N, N, H], dim=-1)
            xbc = torch.cat([xin, b, cm], dim=-1)
            xbc, new_conv = _causal_conv(xbc, lp["conv_w"], conv_cache)
            xbc = F.silu(xbc.float()).to(x.dtype)
            xin, b, cm = torch.split(xbc, [Di, N, N], dim=-1)

        dt = _softplus(dt.float() + lp["dt_bias"][None, None].float())
        dt = torch.clamp(dt, 1e-4, 8.0)                        # [B,S,H]
        la = -torch.exp(lp["a_log"].float())[None, None] * dt  # ≤0
        xh = xin.reshape(B, S, H, dh)
        xb = xh.float() * dt[..., None]
        # on DTensors each rank scans its own rows and heads (the scan's
        # cumsum has a flipped cumsum as its backward, which DTensor
        # does not shard on every torch)
        y, state1 = C.by_rows_and_heads(
            _ssd_chunk, (xb, b, cm, la, state0, self.chunk),
            ((0, 2), (0, None), (0, None), (0, 2), (0, 1), None),
            ((0, 2), (0, 1)))
        y = y + lp["d_skip"].float()[None, None, :, None] * xh.float()
        y = y.reshape(B, S, Di).to(x.dtype)
        y = C.rms_norm(y * F.silu(z.float()).to(x.dtype), lp["norm_g"])
        out = y @ lp["out_proj"].to(x.dtype)
        return out, new_conv, state1

    def _mamba_in_parts(self, lp, x, conv_cache):
        """``_mamba``'s input projection and causal conv over a mesh that
        splits the in_proj, part by part: the fused in_proj's parts (z, x,
        B, C, dt) and the conv's (x, B, C), each a product or a depthwise
        conv of its own, so z, x and dt keep the ``ssm_inner`` split (whole
        heads on each ``model`` rank), which the fused output's split, cut
        at the parts' bounds, loses: DTensor gathers that [B, S, 2Di + 2N
        + H] output whole. The
        parts gather the [D, 2Di + 2N + H] weight instead, for a train or
        prefill step; a decode step keeps the fused product, whose
        one-token output costs less to gather than the weight. The same
        values as the fused path, the gradients summed in another order.
        -> (z, x, B, C, dt, the conv tail [B, K-1, Di + 2N])."""
        c = self.cfg
        Di, N, H = c.d_inner, c.ssm_state, c.ssm_heads
        inner, whole = "ssm_inner", None
        w_in = _split_last(lp["in_proj"].to(x.dtype), [Di, Di, N, N, H])
        z, xin, b, cm, dt = (
            _f32_then_cast(x, shard_activation(w, (None, ax)))
            for w, ax in zip(w_in, (inner, inner, whole, whole, inner)))
        conv_ax = (inner, whole, whole)
        w_conv = _split_last(lp["conv_w"], [Di, N, N])
        tails = ((None,) * 3 if conv_cache is None else
                 [shard_activation(t, ("batch", None, ax)) for t, ax in
                  zip(_split_last(conv_cache, [Di, N, N]), conv_ax)])
        convs = [_causal_conv(t, shard_activation(w, (None, ax)), tail)
                 for t, w, tail, ax in zip((xin, b, cm), w_conv, tails,
                                           conv_ax)]
        xin, b, cm = (F.silu(y.float()).to(x.dtype) for y, _ in convs)
        return (z, xin, b, cm, dt,
                torch.cat([tail for _, tail in convs], dim=-1))

    # ------------------------------------------------- shared attn block
    def _shared_block(self, sp, x, positions, cache, cache_len):
        """Sliding-window GQA with a ring cache of A = min(max_len,
        window) slots.

        Modes: train (cache None), prefill (S>1: full windowed attention,
        then the LAST A tokens are kept, or the S < A tokens written at
        slot 0), decode (S==1: the ring rolls only once ``cache_len`` ≥ A,
        a host branch; attention over the slots' real positions)."""
        c = self.cfg
        B, S, D = x.shape
        dh = c.dh_attn
        sp = C.gather_weights(sp)
        x = shard_activation(x, ("batch", "seq", None))
        h = C.rms_norm(x, sp["ln1"])
        q = _f32_then_cast(h, sp["attn"]["wq"].reshape(D, -1)).reshape(
            B, S, c.n_heads, dh)
        k = _f32_then_cast(h, sp["attn"]["wk"].reshape(D, -1)).reshape(
            B, S, c.n_kv_heads, dh)
        v = _f32_then_cast(h, sp["attn"]["wv"].reshape(D, -1)).reshape(
            B, S, c.n_kv_heads, dh)
        cos, sin = C.rope_tables(positions, dh, c.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q, k = C.apply_rope(q, cos, sin), C.apply_rope(k, cos, sin)
        if cache is None:                                   # train
            o = C.dense_attention(q, k, v, causal=True, q_chunk=self.q_chunk,
                                  window=c.attn_window)
            new_cache = None
        elif S > 1:                                          # prefill
            o = C.dense_attention(q, k, v, causal=True, q_chunk=self.q_chunk,
                                  window=c.attn_window)
            A = cache["k"].shape[1]
            if S >= A:                                       # keep the tail
                new_cache = {"k": k[:, S - A:], "v": v[:, S - A:]}
            else:
                new_cache = {"k": _cache_write(cache["k"], k, 0),
                             "v": _cache_write(cache["v"], v, 0)}
        else:                                                # decode, S == 1
            A = cache["k"].shape[1]
            start = cache_len                                # real position
            slot = torch.arange(A, device=x.device)
            if start >= A:          # roll left by one, the new key last
                ck = torch.cat([cache["k"][:, 1:], k], dim=1)
                cv = torch.cat([cache["v"][:, 1:], v], dim=1)
                kpos = start - A + 1 + slot
            else:
                ck = _cache_write(cache["k"], k, start)
                cv = _cache_write(cache["v"], v, start)
                kpos = slot
            new_cache = {"k": ck, "v": cv}
            win = c.attn_window or 10**9
            invalid = (kpos > start) | (kpos <= start - win)
            s = C._gqa_scores(q, ck) * (1.0 / math.sqrt(dh))
            s = s.masked_fill(invalid[None, None, None, :], -1e30)
            p = torch.softmax(s, dim=-1)
            o = C._gqa_out(p, cv).to(x.dtype)
        a = C.einsum("bshk,hkd->bsd", o, sp["attn"]["wo"].to(x.dtype))
        x = x + a
        m = C.swiglu(C.rms_norm(x, sp["ln2"]), sp["mlp"]["wi_gate"],
                     sp["mlp"]["wi_up"], sp["mlp"]["wo"])
        return x + m, new_cache

    # ------------------------------------------------------------ forward
    def _shared_points(self):
        c = self.cfg
        if not c.shared_every:
            return []
        return [i for i in range(c.n_layers) if i % c.shared_every == c.shared_every - 1]

    def _mamba_layer(self, lp, x, mcache):
        """One mamba block with its residual and the boundary constraints
        (over a mesh, its weights gathered on the data-parallel axes and
        its input whole on the sequence, as the transformer's layer takes
        it: a sequence split would gather the conv's input whole, every
        ``model`` rank then scanning all heads)."""
        c = self.cfg
        if mcache is None:
            cc = None
            s0 = torch.zeros((x.shape[0], c.ssm_heads, c.head_dim,
                              c.ssm_state), dtype=torch.float32,
                             device=x.device)
        else:
            cc, s0 = mcache["conv"], mcache["s"]
        lp = C.gather_weights(lp)
        x = shard_activation(x, ("batch", "seq", None))
        h, nc, s1 = self._mamba(lp, C.rms_norm(x, lp["ln"]), cc, s0)
        x = shard_activation(x + h, ("batch", "seq_save", None))
        return x, {"conv": nc, "s": s1}

    def _backbone(self, params, x, positions, caches=None, cache_len=None):
        pts = set(self._shared_points())
        new_caches = {"mamba": [], "attn": []}
        ai = 0
        remat = caches is None and self.remat
        for i, lp in enumerate(params["layers"]):
            if remat:
                x = checkpoint(lambda lp, x: self._mamba_layer(lp, x, None)[0],
                               lp, x, use_reentrant=False)
            else:
                mc = None if caches is None else caches["mamba"][i]
                x, nc = self._mamba_layer(lp, x, mc)
                new_caches["mamba"].append(nc)
            if i not in pts:
                continue
            if remat:
                x = checkpoint(lambda sp, x: self._shared_block(
                    sp, x, positions, None, None)[0], params["shared"], x,
                    use_reentrant=False)
                continue
            ac = None if caches is None else caches["attn"][ai]
            x, nac = self._shared_block(params["shared"], x, positions,
                                        ac, cache_len)
            new_caches["attn"].append(nac)
            ai += 1
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
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, _ = self._backbone(params, x, pos)
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        return C.softmax_xent(self._logits(params, x), labels,
                              batch.get("loss_mask"))

    def prefill(self, params, batch, max_len: int):
        tokens = batch["tokens"]
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        caches = zeros_placed(lambda d: self.empty_caches(B, max_len, device=d),
                              self.cache_axes()["layers"], tokens.device)
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._backbone(params, x, pos, caches=caches, cache_len=0)
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        return self._logits(params, x[:, -1:]), {"layers": caches, "len": S}

    def decode_step(self, params, cache, tokens):
        """tokens [B,1]; ``cache['len']`` is a host int."""
        B = tokens.shape[0]
        ln = cache["len"]
        pos = torch.full((B, 1), ln, device=tokens.device)
        x = C.embed_lookup(C.gather_weights(params["embed"]), tokens)
        x, caches = self._backbone(params, x, pos, caches=cache["layers"],
                                   cache_len=ln)
        x = C.rms_norm(x, C.gather_weights(params["ln_f"]))
        return self._logits(params, x), {"layers": caches, "len": ln + 1}

    # -------------------------------------------------------------- cache
    def _attn_cache_len(self, S):
        c = self.cfg
        return min(S, c.attn_window) if c.attn_window else S

    def empty_caches(self, B, S, device="cuda"):
        """Per Mamba2 layer the conv tail (compute dtype) and the SSM state
        (f32); per shared-block application a ring of
        ``min(S, attn_window)`` K/V slots."""
        c = self.cfg

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        A, dh = self._attn_cache_len(S), c.dh_attn
        mam = [{"conv": zeros((B, c.conv_width - 1,
                               c.d_inner + 2 * c.ssm_state), C.COMPUTE_DTYPE),
                "s": zeros((B, c.ssm_heads, c.head_dim, c.ssm_state),
                           torch.float32)} for _ in range(c.n_layers)]
        attn = [{"k": zeros((B, A, c.n_kv_heads, dh), C.COMPUTE_DTYPE),
                 "v": zeros((B, A, c.n_kv_heads, dh), C.COMPUTE_DTYPE)}
                for _ in self._shared_points()]
        return {"mamba": mam, "attn": attn}

    def cache_specs(self, B, S):
        """The decode cache's shapes and dtypes as ``meta`` tensors."""
        return {"layers": self.empty_caches(B, S, device="meta"),
                "len": torch.empty((), dtype=torch.int32, device="meta")}

    def cache_axes(self):
        """The logical axes of each ``cache_specs`` leaf (layers unrolled)."""
        one_m = {"conv": ("batch", None, "ssm_inner"),
                 "s": ("batch", "heads", None, None)}
        one_a = {"k": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim"),
                 "v": ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim")}
        mam = [dict(one_m) for _ in range(self.cfg.n_layers)]
        attn = [dict(one_a) for _ in self._shared_points()]
        return {"layers": {"mamba": mam, "attn": attn}, "len": ()}

    def param_count(self):
        return self.cfg.param_count()

    def active_param_count(self):
        return self.cfg.active_param_count()
