"""Multi-process jobs of the port's mesh tests, one process per rank.

Each rank joins a gloo group through a ``FileStore`` in the directory the
test names (``launch.mesh.start_group``), runs one job and writes what it
saw to ``<directory>/<job>_rank<r>.npz``. ``run_ranks`` starts the ranks
as subprocesses and kills them all if they outlast their timeout, so a
hung collective fails its test instead of the suite.

    python tests/_torch_ranks.py <job> <rank> <world> <directory>
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the five serving filter kinds of the mesh-service bank, as
# ``selfcheck.filter_case`` builds them: (kernel, filter_case arg)
BANK_CASES = (("bloom_probe", 0.01), ("xor_probe", (8, "fuse")),
              ("exact_probe", "a"), ("chained_probe", "stage 1"),
              ("cascade_probe", 5))
BANK_PER = 400
BANK_SEED = 3
N_QUERIES = 3001
# the placements job's (data, model) meshes, on 4 ranks
PLACEMENT_MESHES = ((4, 1), (1, 4), (2, 2))


def run_ranks(job: str, world: int, directory, timeout: float = 120.0
              ) -> list[dict]:
    """Run ``job`` on ``world`` rank processes; every rank must exit 0
    within ``timeout`` seconds. -> each rank's saved arrays."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(directory)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    return [dict(np.load(os.path.join(directory, f"{job}_rank{r}.npz")))
            for r in range(world)]


def bank_case():
    """(filters, queries): the port's five filters and ``N_QUERIES``
    queries drawn from their ``filter_case`` query sets."""
    from repro_torch.kernels import selfcheck
    cases = [selfcheck.filter_case(k, a, per=BANK_PER, seed=BANK_SEED)
             for k, a in BANK_CASES]
    q = np.concatenate([c[2] for c in cases])
    q = q[np.random.default_rng(5).permutation(len(q))][:N_QUERIES]
    return [c[3] for c in cases], q


def store_keys() -> np.ndarray:
    """Keys of the mesh store: 3 flushes of 1,500 and 1,500 misses."""
    from repro_torch.core import hashing as H
    return H.random_keys(6000, seed=9)


def _service(rank, world, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import FilterService
    from repro_torch.storage import LsmStore
    mesh = make_mesh((world,), ("data",), device="cpu")
    filters, q = bank_case()
    svc = FilterService(filters, device="cpu", mesh=mesh)
    for n in (N_QUERIES, 0):
        m, p = svc.probe(q[:n])
        out[f"member_{n}"], out[f"probes_{n}"] = m, p
        out[f"filter_{n}"] = np.stack([svc.probe_filter(i, q[:n])
                                       for i in range(len(filters))])
    st = svc.stats
    out["lookups"], out["hits"], out["sum_probes"] = st.lookups, st.hits, st.probes
    keys = store_keys()
    store = LsmStore(filter_kind="chained", seed=1, memtable_capacity=2**62,
                     auto_compact=False, device="cpu", mesh=mesh)
    for i in range(3):
        ks = keys[i * 1500:(i + 1) * 1500]
        store.put_batch(ks, ks >> np.uint64(7))
        store.flush()
    found, vals, reads = store.get_batch(keys)
    out["found"], out["vals"], out["reads"] = found, vals, reads
    out["store_member"], out["store_probes"] = store.service.probe(keys)
    dist.barrier()


def _placements(rank, world, out):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import param_specs_of, spec_leaves
    from repro_torch.models.common import init_from_specs, tree_leaves
    from repro_torch.sharding.rules import (DEFAULT_RULES, local_shape,
                                            placements)
    for dims in PLACEMENT_MESHES:
        mesh = make_mesh(dims, ("data", "model"), device="cpu")
        model = get_arch("llama3.2-1b").model(smoke=True, tp_divisor=dims[1])
        specs = spec_leaves(param_specs_of(mesh, DEFAULT_RULES, model))
        params = tree_leaves(init_from_specs(
            model.param_specs(), torch.Generator().manual_seed(0),
            device="cpu"))
        got, want, split = [], [], 0
        for spec, p in zip(specs, params):
            d = distribute_tensor(p, mesh, placements(mesh, spec))
            got.append(tuple(d.to_local().shape))
            want.append(local_shape(mesh, spec, tuple(p.shape)))
            split += got[-1] != tuple(p.shape)
        tag = "x".join(map(str, dims))
        out[f"got_{tag}"] = np.array([g + (0,) * (3 - len(g)) for g in got])
        out[f"want_{tag}"] = np.array([w + (0,) * (3 - len(w)) for w in want])
        out[f"split_{tag}"] = split
    # a dim split over ('pod', 'data'): which rows this rank holds
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    t = torch.arange(8 * 3).reshape(8, 3)
    d = distribute_tensor(t, mesh, placements(mesh, (("pod", "data"),)))
    out["coord"] = np.array(mesh.get_coordinate())
    out["first_row"] = int(d.to_local()[0, 0]) // 3


def main(argv) -> None:
    job, rank, world, directory = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import start_group
    start_group(directory, rank, world, device="cpu", timeout_s=60.0)
    out: dict = {}
    try:
        {"service": _service, "placements": _placements}[job](rank, world, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(directory, f"{job}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1:])
