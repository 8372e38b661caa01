"""zamba2-2.7b [hybrid] — 54 Mamba2 layers (d_model=2560, ssm_state=64) +
ONE shared attention/MLP block (32H kv=32, d_ff=10240) applied every 6
layers with a 4096-token sliding window [arXiv:2411.15242; hf]."""
from repro_torch.models.ssm import Mamba2Config, Zamba2LM
from .base import ArchDef

FULL = Mamba2Config(
    name="zamba2-2.7b", n_layers=54, d_model=2560, d_ff=10240, vocab=32000,
    ssm_state=64, head_dim=64, expand=2, conv_width=4,
    shared_every=6, n_heads=32, n_kv_heads=32, attn_window=4096)

SMOKE = Mamba2Config(
    name="zamba2-2.7b-smoke", n_layers=4, d_model=128, d_ff=256, vocab=512,
    ssm_state=16, head_dim=32, expand=2, conv_width=4,
    shared_every=2, n_heads=4, n_kv_heads=4, attn_window=16)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    kw.setdefault("chunk", 16 if smoke else 64)
    return Zamba2LM(SMOKE if smoke else FULL, **kw)


ARCH = ArchDef(arch_id="zamba2-2.7b", family="hybrid",
               source="arXiv:2411.15242; hf", make_model=make_model,
               subquadratic=True)
