"""whisper-tiny [audio] — 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865; conv/mel frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356; unverified].

6 heads pad to 16 at tp_divisor=16; vocab pads 51865 -> 51872."""
import torch

from repro_torch.models.encdec import EncDecConfig, EncDecLM
from .base import ArchDef

FULL = EncDecConfig(
    name="whisper-tiny", n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, n_frames=1500, vocab_pad_to=16)

SMOKE = EncDecConfig(
    name="whisper-tiny-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, n_frames=16)


def make_model(smoke: bool, tp_divisor: int = 1, **kw):
    return EncDecLM(SMOKE if smoke else FULL, tp_divisor=tp_divisor, **kw)


def modality_inputs(cfg, B, smoke):
    """Frontend stub: precomputed log-mel frame embeddings, as ``meta``
    tensors."""
    return {"frames": torch.empty((B, cfg.n_frames, cfg.d_model),
                                  dtype=torch.float32, device="meta")}


ARCH = ArchDef(arch_id="whisper-tiny", family="audio",
               source="arXiv:2212.04356; unverified", make_model=make_model,
               modality_inputs=modality_inputs)
