"""Model substrate of the LM serving path: the dense decoder-only
transformer (``transformer.py``) on the shared pieces of ``common.py``."""
