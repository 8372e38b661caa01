"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400, llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, head_dim=128, rope_theta=1e4)

SMOKE = TransformerConfig(
    name="deepseek-7b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=8, d_ff=352, vocab=512, head_dim=16, rope_theta=1e4)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="deepseek-7b", family="dense",
               source="arXiv:2401.02954; hf", make_model=make_model)
