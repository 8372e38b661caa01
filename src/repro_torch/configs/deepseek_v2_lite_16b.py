"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared (expert d_ff=1408), first layer dense
(d_ff=10944), vocab=102400 [arXiv:2405.04434; hf]."""
from repro_torch.models.transformer import TransformerConfig, TransformerLM
from .base import ArchDef

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=10944, vocab=102400, rope_theta=1e4,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408, first_k_dense=1)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=320, vocab=512, rope_theta=1e4,
    mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=64, first_k_dense=1)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return TransformerLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


ARCH = ArchDef(arch_id="deepseek-v2-lite-16b", family="moe",
               source="arXiv:2405.04434; hf", make_model=make_model)
