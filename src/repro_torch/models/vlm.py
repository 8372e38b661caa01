"""InternVL2-style VLM backbone (arXiv:2404.16821), as the reference's
``repro/models/vlm.py``.

The InternViT frontend is a stub: the inputs carry precomputed patch
embeddings [B, n_patches, d_model] (post-projector). The model is the
InternLM2-20B-style text backbone (a GQA ``TransformerLM``) over
[visual prefix ; text tokens]; the LM loss covers the text positions
only, and the decode cache holds the prefix and the text
(``len = n_patches + S`` after a prefill).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.sharding.ctx import zeros_placed

from . import common as C
from .transformer import TransformerConfig, TransformerLM


@dataclass(frozen=True)
class VLMConfig:
    lm: TransformerConfig
    n_patches: int = 256

    @property
    def name(self) -> str:
        return self.lm.name

    def param_count(self) -> int:
        return self.lm.param_count()

    def active_param_count(self) -> int:
        return self.lm.active_param_count()


class VLM:
    def __init__(self, cfg: VLMConfig, tp_divisor: int = 1,
                 q_chunk: int = 2048, remat: bool = False,
                 scan_layers: bool = False):
        self.cfg = cfg
        self.lm = TransformerLM(cfg.lm, tp_divisor=tp_divisor, q_chunk=q_chunk,
                                remat=remat, scan_layers=scan_layers)

    def param_specs(self):
        return self.lm.param_specs()

    def _join(self, params, patch_embeds, tokens):
        vis = patch_embeds.to(C.COMPUTE_DTYPE)
        txt = self.lm._embed(params, tokens)
        return torch.cat([vis, txt], dim=1)

    def _positions(self, B, n, device):
        return torch.arange(n, device=device)[None, :].expand(B, n)

    # -------------------------------------------------------------- entry
    def loss(self, params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        P = batch["patch_embeds"].shape[1]
        x = self._join(params, batch["patch_embeds"], tokens)
        x, _ = self.lm._backbone(params, x, positions=self._positions(
            B, P + S, tokens.device))
        x = self.lm._final_norm(params, x[:, P:])          # text positions
        return C.softmax_xent(self.lm._logits(params, x), labels,
                              batch.get("loss_mask"))

    def prefill(self, params, batch, max_len: int):
        tokens = batch["tokens"]
        B, S = tokens.shape
        P = batch["patch_embeds"].shape[1]
        x = self._join(params, batch["patch_embeds"], tokens)
        caches = zeros_placed(
            lambda d: self.lm.empty_caches(B, max_len, device=d),
            self.cache_axes()["layers"], tokens.device)
        x, caches = self.lm._backbone(
            params, x, positions=self._positions(B, P + S, tokens.device),
            caches=caches, cache_len=0)
        x = self.lm._final_norm(params, x)
        logits = self.lm._logits(params, x[:, -1:])
        return logits, {"layers": caches, "len": P + S}

    def decode_step(self, params, cache, tokens):
        return self.lm.decode_step(params, cache, tokens)

    # -------------------------------------------------------------- cache
    def empty_caches(self, B, S, device="cuda"):
        return self.lm.empty_caches(B, S, device=device)

    def cache_specs(self, B, S):
        """S = the whole cache length (visual prefix + text)."""
        return self.lm.cache_specs(B, S)

    def cache_axes(self):
        return self.lm.cache_axes()

    def param_count(self):
        return self.cfg.param_count()

    def active_param_count(self):
        return self.cfg.active_param_count()
