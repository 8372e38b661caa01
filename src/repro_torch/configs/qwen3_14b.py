"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf].

40 heads are not divisible by the 16-way model axis: q/o heads are
zero-padded to 48 at tp_divisor=16 (zero rows leave the function unchanged)."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6)

SMOKE = TransformerConfig(
    name="qwen3-14b-smoke", n_layers=2, d_model=128, n_heads=5, n_kv_heads=1,
    d_ff=320, vocab=512, head_dim=16, qk_norm=True, rope_theta=1e6)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="qwen3-14b", family="dense",
               source="hf:Qwen/Qwen3-8B; hf", make_model=make_model)
