"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128, rope_theta=1e4)

SMOKE = TransformerConfig(
    name="deepseek-67b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=1, d_ff=352, vocab=512, head_dim=16, rope_theta=1e4)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="deepseek-67b", family="dense",
               source="arXiv:2401.02954; hf", make_model=make_model)
