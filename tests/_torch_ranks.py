"""Multi-process jobs of the port's mesh tests, one process per rank.

Each rank joins a gloo group through a ``FileStore`` in the directory the
test names (``launch.mesh.start_group``), runs one job and writes what it
saw to ``<directory>/<job>_rank<r>.npz``. ``run_ranks`` starts the ranks
as subprocesses and kills them all if they outlast their timeout, so a
hung collective fails its test instead of the suite.

    python tests/_torch_ranks.py <job> <rank> <world> <directory>
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

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
# the sharded-steps job, on 2 ranks: (tag, arch, (data, model) mesh,
# rules, the serve steps after a train step: (prefill length, decodes))
STEP_CASES = (
    ("llama_2x1", "llama3.2-1b", (2, 1), "default", None),
    ("llama_1x2", "llama3.2-1b", (1, 2), "default", (12, 4)),
    ("llama_1x2_sp", "llama3.2-1b", (1, 2), "sp", None),
    ("deepseek_1x2", "deepseek-v2-lite-16b", (1, 2), "default", (12, 2)),
    ("deepseek_1x2_sp", "deepseek-v2-lite-16b", (1, 2), "sp", (12, 2)),
    ("deepseek_2x1", "deepseek-v2-lite-16b", (2, 1), "default", None),
    ("internvl_2x1", "internvl2-26b", (2, 1), "default", None),
)
# the grouped-query attention job, on 2 ranks: a (1, 2) mesh whose
# 'model' axis does not divide the kv heads, so the rules replicate them
# while the q heads split: 1 kv head for 8 q heads, and 3 kv heads for
# 6 q heads (g = 2: rank 0's q heads read kv heads 0, 0, 1, rank 1's
# 1, 2, 2)
GQA_CASES = (
    ("llama_kv1_1x2", "llama3.2-1b/kv1", (1, 2), "default", (12, 2)),
    ("llama_kv1_1x2_hd", "llama3.2-1b/kv1", (1, 2), "head_dim", (12, 2)),
    ("llama_kv3_1x2", "llama3.2-1b/kv3", (1, 2), "default", (12, 2)),
)
# an arch of a case that is not registered: (the registered arch, the
# fields of its smoke config that differ)
VARIANTS = {"llama3.2-1b/kv1": ("llama3.2-1b", {"n_kv_heads": 1}),
            "llama3.2-1b/kv3": ("llama3.2-1b", {"n_heads": 6,
                                                "n_kv_heads": 3})}
# the other families: (1, 2) under DEFAULT_RULES (and rwkv6 under
# SP_RULES too, whose sequence-split layer boundaries the train cells
# take), a train step, a 12-token prefill and 2 decode steps
FAMILY_CASES = (
    ("zamba2_1x2", "zamba2-2.7b", (1, 2), "default", (12, 2)),
    ("rwkv6_1x2", "rwkv6-7b", (1, 2), "default", (12, 2)),
    ("rwkv6_1x2_sp", "rwkv6-7b", (1, 2), "sp", (12, 2)),
    ("whisper_1x2", "whisper-tiny", (1, 2), "default", (12, 2)),
)
STEP_SEED = 2
# the families whose steps on a 1-rank mesh are held to one device's bit
# for bit (the card test's archs)
ONE_RANK_ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                  "rwkv6-7b", "whisper-tiny")
# the MoE block alone on (world, 1), the deepseek-v2-lite smoke's
# widths: batch x seq tokens, and group sizes that make 2 groups of 128
# (on 2 ranks each routes its own; the expert most tokens choose drops
# all but 40 a group) and 1 group (each rank routes the whole batch)
MOE_BATCH, MOE_SEQ, MOE_GROUP_SIZES = 4, 64, (128, 256)
# the sharded supervisor: steps, a checkpoint every 4, a failure at 6
SUP_STEPS, SUP_SAVE_EVERY, SUP_FAIL_AT = 10, 4, (6,)


class Ranks:
    """The rank processes of one job, started; ``wait()`` collects them."""

    def __init__(self, job: str, world: int, directory, timeout: float):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src")]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        env["OMP_NUM_THREADS"] = "1"
        self.job, self.directory = job, str(directory)
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r),
             str(world), self.directory], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self) -> list[dict]:
        """Every rank must exit 0 before the deadline (else all are
        killed). -> each rank's saved arrays."""
        try:
            outs = [p.communicate(timeout=max(
                1.0, self.deadline - time.monotonic()))[0]
                for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"{self.job} rank {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
        return [dict(np.load(os.path.join(self.directory,
                                          f"{self.job}_rank{r}.npz")))
                for r in range(len(self.procs))]


def start_ranks(job: str, world: int, directory, timeout: float = 120.0
                ) -> Ranks:
    """Start ``job`` on ``world`` rank processes, each killed if the job
    outlasts ``timeout`` seconds; the caller may work meanwhile."""
    return Ranks(job, world, directory, timeout)


def run_ranks(job: str, world: int, directory, timeout: float = 120.0
              ) -> list[dict]:
    """Run ``job`` on ``world`` rank processes; every rank must exit 0
    within ``timeout`` seconds. -> each rank's saved arrays."""
    return start_ranks(job, world, directory, timeout).wait()


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


def keyed(tree, prefix: str = "") -> dict:
    """{path: numpy leaf} of a tree of dicts and lists (either package's
    tensors, numpy arrays or host ints)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in keyed(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in keyed(sub, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy() if hasattr(tree, "detach")
            else np.asarray(tree)}


def np_params(model, seed: int):
    """Numpy weights for ``model``'s specs: normal of std ``scale /
    sqrt(fan_in)``, the norms' gains 1 + N(0, 0.1) (a wrong gain shows),
    zeros as zeros."""
    from repro_torch.models.common import tree_map
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return (1 + 0.1 * rng.normal(size=spec.shape)).astype(np.float32)
        std = spec.scale / np.sqrt(max(1, spec.shape[0]))
        return (rng.normal(size=spec.shape) * std).astype(np.float32)
    return tree_map(one, model.param_specs())


def carried_opt(params, step: int = 10) -> dict:
    """An AdamW state to continue from, v > 0 (a smooth update: from zero
    moments the first update is lr * g / (|g| + eps), which two summation
    orders move by up to 2 lr where |g| is near eps)."""
    from repro_torch.models.common import tree_map
    m = tree_map(lambda p: np.float32(0.01) * p, params)
    return {"m": m, "v": tree_map(lambda a: np.float32(1e-6) + a * a, m),
            "step": np.int32(step)}


def case_arch(arch_id: str, get_arch=None):
    """The ``ArchDef`` of a case's arch (a variant's registered arch), from
    the port's registry or the one ``get_arch`` reads."""
    if get_arch is None:
        from repro_torch.configs import get_arch
    return get_arch(VARIANTS.get(arch_id, (arch_id,))[0])


def case_model(arch_id: str, get_arch=None, **kw):
    """The smoke model of a case's arch built with ``kw``, or None for a
    registered arch (the cells build their own): a variant's smoke config
    with its fields replaced, in the port's classes or those of the
    registry ``get_arch`` reads."""
    import dataclasses
    if arch_id not in VARIANTS:
        return None
    m = case_arch(arch_id, get_arch).model(smoke=True, **kw)
    return type(m)(dataclasses.replace(m.cfg, **VARIANTS[arch_id][1]), **kw)


def step_inputs(model, arch_id: str, smoke_batch: int = 2) -> dict:
    """The numpy inputs of a STEP_CASES case: a ``train_4k`` batch at
    smoke width (2 x 32 tokens and labels, with the arch's modality
    inputs: a VLM's patch or an encoder's frame embeddings), a serve
    prompt of 2 x 12 tokens (the same modality inputs beside it) and the
    decode tokens."""
    rng = np.random.default_rng(STEP_SEED + 1)
    vocab = getattr(model.cfg, "lm", model.cfg).vocab
    toks = rng.integers(0, vocab, (smoke_batch, 33)).astype(np.int32)
    arch = case_arch(arch_id)
    extra = {k: (rng.normal(size=v.shape) * 0.25).astype(np.float32)
             for k, v in (arch.modality_inputs(model.cfg, smoke_batch, True)
                          if arch.modality_inputs else {}).items()}
    return {"batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                      **extra},
            "prompt": rng.integers(0, vocab, (smoke_batch, 12)).astype(
                np.int32),
            "decode": rng.integers(0, vocab, (4, smoke_batch, 1)).astype(
                np.int32),
            "extra": extra}


def serve_batch(inp, n: int, lib) -> dict:
    """A prefill's batch: the first ``n`` prompt tokens and the modality
    inputs, as ``lib`` arrays."""
    return {"tokens": lib(inp["prompt"][:, :n]),
            **{k: lib(v) for k, v in inp["extra"].items()}}


def port_reference(arch_id: str, serve) -> dict:
    """The one-device port's results of a STEP_CASES / FAMILY_CASES case
    (f32 compute, the caller's): the train cell's step and the gradients
    of its batch, and with ``serve`` = (prefill length, decode steps) the
    prefill and decode cells' steps, as {key: numpy} under the keys the
    rank jobs write after their tag."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    arch = case_arch(arch_id)
    cell = steps.build_cell(arch, "train_4k", device="cpu", smoke=True,
                            model=case_model(arch_id, remat=True,
                                             q_chunk=512))
    npp = np_params(cell.model, STEP_SEED)
    inp = step_inputs(cell.model, arch_id)
    p = C.params_from_numpy(npp, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    _, grads = steps.loss_and_grads(cell.model, p, batch)
    p2, o2, met = cell.step(p, C.params_from_numpy(carried_opt(npp), "cpu"),
                            batch)
    out = keyed({"params": p2, "opt": o2, "grad": grads})
    out["loss"], out["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    if serve is not None:
        serving = case_model(arch_id, remat=True, q_chunk=1024)
        pcell = steps.build_cell(arch, "prefill_32k", device="cpu", smoke=True,
                                 model=serving)
        dcell = steps.build_cell(arch, "decode_32k", device="cpu", smoke=True,
                                 model=serving)
        lg, cache = pcell.step(p, serve_batch(inp, serve[0],
                                              torch.from_numpy))
        out["/prefill_logits"] = lg.numpy()
        for i in range(serve[1]):
            lg, cache = dcell.step(p, cache, torch.from_numpy(inp["decode"][i]))
            out[f"/decode_logits_{i}"] = lg.numpy()
        out.update(keyed(cache, "/cache"))
    return out


def jax_reference(arch_id: str, serve) -> dict:
    """The JAX reference's results of a STEP_CASES / FAMILY_CASES case,
    under ``port_reference``'s keys, from the same numpy params, AdamW
    state and inputs: its train cell's step on the host mesh, the
    gradients of its model's loss on the step's batch (``jax.grad``), and
    with ``serve`` its model's prefill (to the port's prefill cell's
    length) and decode steps. Only the tests import JAX; a rank never
    calls this."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.launch import steps as JS
    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch import steps
    jcell = JS.build_cell(case_arch(arch_id, jax_get_arch), "train_4k",
                          make_host_mesh(), smoke=True, donate=False,
                          model=case_model(arch_id, jax_get_arch, remat=True,
                                           q_chunk=512))
    jm = jcell.model
    model = case_model(arch_id) or case_arch(arch_id).model(smoke=True)
    npp = np_params(model, STEP_SEED)
    inp = step_inputs(model, arch_id)
    jp = jax.tree.map(jnp.asarray, npp)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    p2, o2, met = jcell.jitted(jp, jax.tree.map(jnp.asarray,
                                                carried_opt(npp)), batch)
    grads = jax.jit(jax.grad(jm.loss))(jp, batch)
    out = keyed(jax.tree.map(np.asarray, {"params": p2, "opt": o2,
                                          "grad": grads}))
    out["loss"], out["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    if serve is not None:
        # the model's own prefill and decode_step, which the serving cells
        # wrap: under this JAX the prefill cell's explicit host-mesh axes
        # refuse its unannotated empty cache's update on the CPU
        max_len = steps.build_cell(case_arch(arch_id), "prefill_32k",
                                   device="meta", smoke=True,
                                   model=case_model(arch_id)).abstract_args[
                                       1]["tokens"].shape[1]
        lg, cache = jax.jit(lambda p_, b: jm.prefill(p_, b, max_len))(
            jp, serve_batch(inp, serve[0], jnp.asarray))
        out["/prefill_logits"] = np.asarray(lg)
        decode = jax.jit(jm.decode_step)
        for i in range(serve[1]):
            lg, cache = decode(jp, cache, jnp.asarray(inp["decode"][i]))
            out[f"/decode_logits_{i}"] = np.asarray(lg)
        out.update(keyed(jax.tree.map(np.asarray, cache), "/cache"))
    return out


def rel_l2(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


# the step tests' tolerances (``tests/test_torch_train.py``): the loss
# relative, the gradient leaves relative L2, the rest absolute + relative
LOSS_RTOL, GRAD_REL, TOL = 1e-6, 1e-5, dict(rtol=1e-5, atol=1e-5)


def check_train(got: dict, tag: str, wants: list,
                grad_rel: float = GRAD_REL) -> None:
    """A rank's train results for ``tag`` against each of ``wants``
    (``port_reference``-like dicts; the first must carry the gradients,
    and every other that does is held to them too, each leaf within
    ``grad_rel`` relative L2): the loss, grad_norm, every param and AdamW
    leaf, the step count, every gradient leaf."""
    for want in wants:
        np.testing.assert_allclose(got[f"{tag}_loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{tag}_grad_norm"],
                                   want["grad_norm"], rtol=1e-5)
    keys = [k for k in wants[0] if k.startswith(("/params/", "/opt/"))]
    for want in wants:
        assert keys and sorted(keys) == sorted(
            k for k in want if k.startswith(("/params/", "/opt/")))
        for key in keys:
            np.testing.assert_allclose(got[tag + key], want[key], **TOL,
                                       err_msg=key)
    assert int(got[f"{tag}/opt/step"]) == 11
    grads = [k for k in wants[0] if k.startswith("/grad/")]
    assert len(grads) == len([k for k in keys if k.startswith("/params/")])
    for want in wants:
        if any(k.startswith("/grad/") for k in want):
            assert sorted(k for k in want if k.startswith("/grad/")) == \
                sorted(grads)
            for key in grads:
                assert rel_l2(got[tag + key], want[key]) <= grad_rel, key


def check_serve(got: dict, tag: str, serve, wants: list) -> None:
    """A rank's prefill logits, each decode step's logits and the cache
    after the last step for ``tag`` against each of ``wants``."""
    keys = ["/prefill_logits"] + [f"/decode_logits_{i}"
                                  for i in range(serve[1])]
    keys += [k for k in wants[0] if k.startswith("/cache/")]
    assert int(got[f"{tag}/cache/len"]) == int(wants[0]["/cache/len"])
    for want in wants:
        for key in keys:
            np.testing.assert_allclose(got[tag + key], want[key], **TOL,
                                       err_msg=key)


def check_placed(got: dict, tag: str, serve) -> None:
    """Every placed argument and result of ``tag`` carried its spec's
    placements, and the local bytes equal ``Cell.arg_local_bytes()``."""
    assert got[f"{tag}_placed_ok"] and got[f"{tag}_out_placed_ok"]
    assert list(got[f"{tag}_local_bytes"]) == list(got[f"{tag}_cell_bytes"])
    if serve is not None:
        assert got[f"{tag}_decode_placed_ok"]
        assert got[f"{tag}_cache_placed_ok"]
        assert list(got[f"{tag}_decode_local_bytes"]) == list(
            got[f"{tag}_decode_cell_bytes"])


def collect(started: list) -> dict:
    """Rank 0's results of the started jobs, merged; rank 1's must equal
    them bit for bit."""
    merged = {}
    for r0, *rest in (r.wait() for r in started):
        for other in rest:
            assert sorted(r0) == sorted(other)
            for k, v in r0.items():
                np.testing.assert_array_equal(v, other[k], err_msg=k)
        merged.update(r0)
    return merged


def _placed_as_specs(tree, spec_tree, mesh) -> bool:
    """Whether every tensor leaf of ``tree`` is a DTensor placed as
    ``placements(mesh, spec)`` of its spec in ``spec_tree``."""
    import torch
    from repro_torch.launch.steps import spec_leaves
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding.rules import placements
    return all(tuple(getattr(t, "placements", ())) == tuple(
        placements(mesh, sp)) for t, sp in zip(tree_leaves(tree),
                                               spec_leaves(spec_tree))
        if isinstance(t, torch.Tensor))


def _step_cases(cases, out):
    """The sharded train, prefill and decode steps of ``cases`` (rows of
    STEP_CASES), from numpy params (f32 compute): the results (full
    values), the gradients of the train batch, whether every placed
    argument and result carries its spec's placements, and the local
    bytes of the placed arguments beside ``Cell.arg_local_bytes``
    (a decode cell's too, from bf16 params and an empty cache)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell, loss_and_grads, sharded
    from repro_torch.models import common as C
    from repro_torch.sharding.rules import (DEFAULT_RULES, SP_RULES, full_tree,
                                            local_bytes)
    C.set_compute_dtype(torch.float32)
    rules_of = {"default": DEFAULT_RULES, "sp": SP_RULES,
                "head_dim": DEFAULT_RULES.override(heads=None,
                                                   head_dim="model")}
    for tag, arch_id, dims, rules_name, serve in cases:
        rules = rules_of[rules_name]
        mesh = make_mesh(dims, ("data", "model"), device="cpu")
        arch = case_arch(arch_id)
        cell = build_cell(arch, "train_4k", device="cpu", mesh=mesh,
                          rules=rules, smoke=True,
                          model=case_model(arch_id, tp_divisor=dims[1],
                                           remat=True, q_chunk=512))
        m = cell.model
        npp = np_params(m, STEP_SEED)
        inp = step_inputs(m, arch_id)
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        args = (C.params_from_numpy(npp, "cpu"),
                C.params_from_numpy(carried_opt(npp), "cpu"), batch)
        placed = cell.place(args)
        out[f"{tag}_placed_ok"] = all(_placed_as_specs(a, sp, mesh) for a, sp
                                      in zip(placed, cell.arg_specs))
        out[f"{tag}_local_bytes"] = [local_bytes(a) for a in placed]
        out[f"{tag}_cell_bytes"] = list(cell.arg_local_bytes().values())
        with sharded(mesh, rules):
            loss, grads = loss_and_grads(m, placed[0], placed[2])
        for k, v in keyed(full_tree(grads), f"{tag}/grad").items():
            out[k] = v
        p2, o2, met = cell.step(*placed)
        out[f"{tag}_out_placed_ok"] = (
            _placed_as_specs(p2, cell.arg_specs[0], mesh)
            and _placed_as_specs(o2, cell.arg_specs[1], mesh))
        out[f"{tag}_loss"] = float(met["loss"])
        out[f"{tag}_grad_norm"] = float(met["grad_norm"])
        for k, v in keyed({"params": full_tree(p2), "opt": full_tree(o2)},
                          f"{tag}").items():
            out[k] = v
        if serve is None:
            continue
        params = args[0]
        serving = case_model(arch_id, tp_divisor=dims[1], remat=True,
                             q_chunk=1024)
        pcell = build_cell(arch, "prefill_32k", device="cpu", mesh=mesh,
                           rules=rules, smoke=True, model=serving)
        dcell = build_cell(arch, "decode_32k", device="cpu", mesh=mesh,
                           rules=rules, smoke=True, model=serving)
        cache0 = C.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                            dcell.abstract_args[1])
        cache0["len"] = 0
        bf16 = C.tree_map(lambda t: t.to(torch.bfloat16), params)
        dplaced = dcell.place((bf16, cache0, torch.zeros(
            dcell.abstract_args[2].shape, dtype=torch.int32)))
        out[f"{tag}_decode_placed_ok"] = all(
            _placed_as_specs(a, sp, mesh)
            for a, sp in zip(dplaced, dcell.arg_specs))
        out[f"{tag}_decode_local_bytes"] = [local_bytes(a) for a in dplaced]
        out[f"{tag}_decode_cell_bytes"] = list(
            dcell.arg_local_bytes().values())
        del dplaced, bf16
        lg, cache = pcell.step(params, serve_batch(inp, serve[0],
                                                   torch.from_numpy))
        out[f"{tag}/prefill_logits"] = lg.numpy()
        out[f"{tag}_cache_placed_ok"] = _placed_as_specs(
            cache, dcell.arg_specs[1], mesh)
        for i in range(serve[1]):
            lg, cache = dcell.step(params, cache,
                                   torch.from_numpy(inp["decode"][i]))
            out[f"{tag}/decode_logits_{i}"] = lg.numpy()
        for k, v in keyed(full_tree(cache), f"{tag}/cache").items():
            out[k] = v


def _moe_groups(out):
    """``moe_block`` at the deepseek-v2-lite smoke's widths on a (world,
    1) mesh inside a step's context, its input split on the batch (f32):
    for each of MOE_GROUP_SIZES, the rows each dispatch call saw, the
    output and the gradients of the input and of every weight (full
    values), the same of the one-device block, and how many (token,
    choice) pairs its groups drop."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import sharded
    from repro_torch.models import common as C
    from repro_torch.sharding.rules import (DEFAULT_RULES, distribute_tree,
                                            full_tree, placements,
                                            tree_specs)
    world = int(os.environ["RANKS_WORLD"])
    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    cfg = get_arch("deepseek-v2-lite-16b").model(smoke=True).cfg
    specs = C.moe_param_specs(cfg.d_model, cfg.moe_d_ff, cfg.n_experts)
    rng = np.random.default_rng(STEP_SEED + 5)
    npp = C.tree_map(lambda sp: (rng.normal(size=sp.shape) / np.sqrt(
        sp.shape[-2])).astype(np.float32), specs)
    # a router that favours expert 0 for every token, so that its slots
    # overflow and the groups drop pairs
    npp["router"][:, 0] += 0.1
    x = (1 + rng.normal(size=(MOE_BATCH, MOE_SEQ, cfg.d_model))).astype(
        np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    seen = []
    dispatch = C._moe_dispatch
    C._moe_dispatch = lambda xs, router, **kw: (
        seen.append(xs.shape[0]), dispatch(xs, router, **kw))[1]
    w_specs = tree_specs(mesh, DEFAULT_RULES,
                         C.tree_map(lambda sp: sp.axes, specs), specs)
    try:
        for gs in MOE_GROUP_SIZES:
            def run(on_mesh):
                p = C.params_from_numpy(npp, "cpu")
                xt = torch.from_numpy(x)
                if on_mesh:
                    p = distribute_tree(p, mesh, w_specs)
                    xt = distribute_tensor(xt, mesh, placements(mesh, (
                        "data",)))
                leaves = [t.detach().requires_grad_(True)
                          for t in [xt] + C.tree_leaves(p)]
                ctx = (sharded(mesh, DEFAULT_RULES) if on_mesh
                       else contextlib.nullcontext())
                with ctx:
                    w = C.gather_weights(C.tree_unflatten(p, leaves[1:]))
                    y = C.moe_block(leaves[0], w, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k, group_size=gs)
                    grads = torch.autograd.grad(
                        (y * torch.from_numpy(cot)).sum(), leaves)
                return full_tree([y.detach()] + list(grads))
            seen.clear()
            got = run(True)
            out[f"moe_{gs}_rows"] = np.array(seen)
            want = run(False)
            xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
            _, gidx = C.moe_route(xt, torch.from_numpy(npp["router"]),
                                  cfg.top_k)
            g, _, cap = C.moe_capacity(len(xt), cfg.top_k, cfg.n_experts,
                                       group_size=gs)
            out[f"moe_{gs}_dropped"] = int(
                (~C.moe_slots(gidx, g, cfg.n_experts, cap)[1]).sum())
            for i, (g, w) in enumerate(zip(got, want)):
                out[f"moe_{gs}_got_{i}"] = g.numpy()
                out[f"moe_{gs}_want_{i}"] = w.numpy()
    finally:
        C._moe_dispatch = dispatch


def _steps(rank, world, out):
    """The llama cases of STEP_CASES."""
    _step_cases([c for c in STEP_CASES if c[1] == "llama3.2-1b"], out)


def _steps_moe(rank, world, out):
    """The MoE/MLA and VLM cases of STEP_CASES, ``moe_block`` on its own
    groups, and ``matmul_f32``'s placements."""
    _step_cases([c for c in STEP_CASES if c[1] != "llama3.2-1b"], out)
    _moe_groups(out)
    _products(out)


def _steps_gqa(rank, world, out):
    """The GQA_CASES: kv heads that the 'model' axis does not divide."""
    _step_cases(GQA_CASES, out)


def _steps_rwkv(rank, world, out):
    """The RWKV6 case of FAMILY_CASES."""
    _step_cases([c for c in FAMILY_CASES if c[1] == "rwkv6-7b"], out)


def _steps_zamba2(rank, world, out):
    """The Zamba2 case of FAMILY_CASES."""
    _step_cases([c for c in FAMILY_CASES if c[1] == "zamba2-2.7b"], out)


def _steps_whisper(rank, world, out):
    """The whisper case of FAMILY_CASES."""
    _step_cases([c for c in FAMILY_CASES if c[1] == "whisper-tiny"], out)


def _one_rank(rank, world, out):
    """The CPU twin of the card's ``test_sharded_steps_on_card_match_one_
    device``: each ONE_RANK_ARCHS smoke model (no remat, bf16 compute
    from f32 params drawn from a seed) on a 1-rank (1, 1) mesh against
    one device: whether the train step's loss, params and AdamW state,
    and a 12-token prefill's and 2 decode steps' logits are equal bit for
    bit."""
    import warnings
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import common as C
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    C.set_compute_dtype(torch.bfloat16)
    mesh = make_host_mesh("cpu")
    for arch_id in ONE_RANK_ARCHS:
        m = get_arch(arch_id).model(smoke=True)
        p = C.init_from_specs(m.param_specs(),
                              torch.Generator().manual_seed(0), "cpu")
        inp = step_inputs(m, arch_id)
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            one, sh = (make_train_step(m, AdamWConfig(), **kw)(
                p, adamw_init(p), batch) for kw in ({}, {"mesh": mesh}))
        out[f"{arch_id}_train_equal"] = torch.equal(
            one[2]["loss"], sh[2]["loss"]) and all(
            torch.equal(a, b.full_tensor()) for a, b in
            zip(C.tree_leaves(one[:2]), C.tree_leaves(sh[:2])))
        bp = C.tree_map(lambda t: t.to(torch.bfloat16), p)
        prompt = serve_batch(inp, 12, torch.from_numpy)
        (lg1, c1), (lg2, c2) = (make_prefill_step(m, 16, **kw)(bp, prompt)
                                for kw in ({}, {"mesh": mesh}))
        equal = torch.equal(lg1, lg2)
        for i in range(2):
            step = torch.from_numpy(inp["decode"][i])
            lg1, c1 = make_serve_step(m)(bp, c1, step)
            lg2, c2 = make_serve_step(m, mesh=mesh)(bp, c2, step)
            equal = equal and torch.equal(lg1, lg2)
        out[f"{arch_id}_serve_equal"] = equal


def _supervisor(rank, world, out):
    """``build_trainer(mesh=)`` of the smoke llama (f32) under the
    supervisor on (2, 1): SUP_STEPS steps uninterrupted, then again with a
    failure at SUP_FAIL_AT, each in its own checkpoint directory."""
    import torch
    import torch.distributed as dist
    from repro_torch.ft.supervisor import FailureInjector, Supervisor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import common as C
    C.set_compute_dtype(torch.float32)
    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    base = os.path.join(os.environ["RANKS_DIR"], "supervisor")
    for name, fail_at in (("clean", ()), ("failed", SUP_FAIL_AT)):
        init_state, step_fn, _ = build_trainer("llama3.2-1b", smoke=True,
                                               device="cpu", mesh=mesh)
        res = Supervisor(os.path.join(base, name),
                         save_every=SUP_SAVE_EVERY).run(
            init_state=init_state, step_fn=step_fn, n_steps=SUP_STEPS,
            injector=FailureInjector(fail_at))
        out[f"sup_{name}_losses"] = np.array(res.losses)
        out[f"sup_{name}_restarts"] = res.n_restarts
        dist.barrier()


def _products(out):
    """``matmul_f32`` of DTensors on a (1, world) mesh: a contraction over
    the split dim (a [6, 8] split on K, b [8, 5] split on K) gives a
    ``Partial`` sum; b split on N gives an output split on N; both equal
    the plain product."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as C
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device="cpu")
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(6, 8, generator=g), torch.randn(8, 5 * 2, generator=g)
    cases = {"contract": ([Replicate(), Shard(1)], [Replicate(), Shard(0)]),
             "columns": ([Replicate(), Replicate()], [Replicate(), Shard(1)]),
             "a_on_k": ([Replicate(), Shard(1)], [Replicate(), Replicate()])}
    for name, (pa, pb) in cases.items():
        y = C.matmul_f32(distribute_tensor(a, mesh, pa),
                         distribute_tensor(b, mesh, pb))
        out[f"mm_{name}_placements"] = str(tuple(y.placements))
        out[f"mm_{name}_err"] = float((y.full_tensor() - a @ b).abs().max())


def main(argv) -> None:
    job, rank, world, directory = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import start_group
    start_group(directory, rank, world, device="cpu", timeout_s=60.0)
    os.environ["RANKS_DIR"] = directory
    os.environ["RANKS_WORLD"] = str(world)
    out: dict = {}
    try:
        {"service": _service, "placements": _placements, "steps": _steps,
         "steps_moe": _steps_moe, "supervisor": _supervisor,
         "steps_gqa": _steps_gqa,
         "steps_rwkv": _steps_rwkv, "steps_zamba2": _steps_zamba2,
         "steps_whisper": _steps_whisper,
         "one_rank": _one_rank}[job](rank, world, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(directory, f"{job}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1:])
