"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

40 heads pad to 48 at tp_divisor=16."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=1, n_shared_experts=1, moe_d_ff=8192, first_k_dense=0)

SMOKE = TransformerConfig(
    name="llama4-scout-smoke", n_layers=2, d_model=128, n_heads=5,
    n_kv_heads=1, d_ff=256, vocab=512, head_dim=16, rope_theta=5e5,
    n_experts=4, top_k=1, n_shared_experts=1, moe_d_ff=256, first_k_dense=0)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="llama4-scout-17b-a16e", family="moe",
               source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
               make_model=make_model)
