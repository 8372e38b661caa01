"""internvl2-26b [vlm] — InternViT frontend STUB + InternLM2-20B text
backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. Vocab pads 92553 -> 92560 for the 16-way TP axis."""
import torch

from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.vlm import VLMConfig, VLM
from .base import ArchDef

FULL = VLMConfig(lm=TransformerConfig(
    name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128, rope_theta=1e6, vocab_pad_to=16),
    n_patches=256)

SMOKE = VLMConfig(lm=TransformerConfig(
    name="internvl2-26b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab=509, head_dim=16, rope_theta=1e6,
    vocab_pad_to=16), n_patches=8)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return VLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


def modality_inputs(cfg, B, smoke):
    """Frontend stub: post-projector visual patch embeddings, as ``meta``
    tensors."""
    return {"patch_embeds": torch.empty((B, cfg.n_patches, cfg.lm.d_model),
                                        dtype=torch.float32, device="meta")}


ARCH = ArchDef(arch_id="internvl2-26b", family="vlm",
               source="arXiv:2404.16821; hf", make_model=make_model,
               modality_inputs=modality_inputs)
