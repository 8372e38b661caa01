"""PyTorch + CUDA port of the ChainedFilter serving system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module (``repro/<pkg>/<mod>.py`` ->
``repro_torch/<pkg>/<mod>.py``) and returns the same bits for the same keys
and seeds. It imports torch, numpy and the standard library only. Its
probe kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use (``kernels/_build.py``); entry points run on the
card unless the caller passes ``device="cpu"``, where the kernels' plain
torch versions run instead.
"""
