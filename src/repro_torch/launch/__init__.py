"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):
``serve``, ``train`` and ``dryrun`` (the census of every (arch, shape)
cell on the production meshes, on ``meta`` tensors), with ``steps``
(the step builders) and ``mesh`` (process groups and meshes).

Not ported, by decision:

- ``hlo_tools`` and ``hbm_model`` parse XLA's HLO text (collectives, the
  largest buffers, a liveness peak). Torch emits no HLO, so they have
  nothing to read.
- ``calibrate`` corrects XLA's ``cost_analysis`` of scanned layer loops
  (it counts a scan body once). The port never scans layers and has no
  ``cost_analysis``; ``chip_smoke.py`` reads device times with
  ``torch.profiler`` and memory with the allocator's counters instead.
- ``perf_iter`` compiles one cell under a variant of the sharding rules
  and reads XLA's analyses; without XLA it has nothing to compile.

These four are the only modules of the reference without a counterpart.
The steps run sharded over a ``DeviceMesh`` (``steps.build_cell(mesh=)``,
``sharding/ctx.py``): params, AdamW state, batches and caches as DTensors
placed by the sharding rules, activations constrained at the reference's
points.
"""
