"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):
``serve``, ``train``, ``dryrun`` (every (arch, shape) cell on the
production meshes, its step traced on ``meta`` tensors over a fake
process group), ``perf_iter`` (one cell under a rules variant) and
``calibrate`` (depth-extrapolated totals), with ``steps`` (the step
builders), ``mesh`` (process groups and meshes), ``op_trace`` (the step
trace: the reference's ``hlo_tools`` questions asked of the local aten
ops and collectives a step runs) and ``hbm_model`` (the liveness peak
over a trace).

Every module of the reference's ``launch/`` has a counterpart. The
steps run sharded over a ``DeviceMesh`` (``steps.build_cell(mesh=)``,
``sharding/ctx.py``): params, AdamW state, batches and caches as
DTensors placed by the sharding rules, activations constrained at the
reference's points.
"""
