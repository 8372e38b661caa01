"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=64, rope_theta=5e5)

SMOKE = TransformerConfig(
    name="llama3.2-1b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=16, rope_theta=5e5)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="llama3.2-1b", family="dense",
               source="hf:meta-llama/Llama-3.2-1B; unverified",
               make_model=make_model)
