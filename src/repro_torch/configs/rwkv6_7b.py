"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attn-free, data-dependent
decay) d_ff=14336 vocab=65536 [arXiv:2404.05892; hf]."""
from repro_torch.models.rwkv6 import RWKV6Config, RWKV6LM
from .base import ArchDef

FULL = RWKV6Config(
    name="rwkv6-7b", n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    head_dim=64, decay_lora=64)

SMOKE = RWKV6Config(
    name="rwkv6-7b-smoke", n_layers=2, d_model=128, d_ff=448, vocab=512,
    head_dim=32, decay_lora=8)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    kw.setdefault("chunk", 16 if smoke else 64)
    return RWKV6LM(SMOKE if smoke else FULL, **kw)


ARCH = ArchDef(arch_id="rwkv6-7b", family="ssm",
               source="arXiv:2404.05892; hf", make_model=make_model,
               subquadratic=True)
