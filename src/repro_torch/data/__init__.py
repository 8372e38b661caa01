"""The training data pipeline: synthetic next-token batches behind a
Bloom-staged document dedup (the reference's ``repro/data``)."""
from .pipeline import SyntheticLMData, DataConfig
from .dedup import StreamingDedup

__all__ = ["SyntheticLMData", "DataConfig", "StreamingDedup"]
