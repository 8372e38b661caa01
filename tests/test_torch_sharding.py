"""Port parity, slice 11: the sharding rules, the meshes and the dry-run
census, against the JAX package on the CPU.

- ``sharding/rules.py``: the reference's ``tests/test_sharding.py`` cases
  on the port (fake 16x16 and 2x16x16 meshes), then every arch of the
  registry at FULL width: each param leaf's and each decode-cache leaf's
  partition entries held to the reference's ``partition_spec`` at 16x16
  and 2x16x16 under the default and the sequence-parallel rules, with
  ``tp_divisor`` 16. The reference is called with its own fake mesh.
- ``launch/dryrun.py``: ``run_cell``'s per-device argument bytes and
  parameter counts held to the reference's
  ``build_cell(...).arg_local_bytes()`` on a 16x16 mesh of 256 host CPU
  devices (one JAX subprocess, nothing lowered); its fields; ``main``.
- ``placements`` on 4 gloo ranks (``tests/_torch_ranks.py``): each smoke
  llama leaf distributed as a DTensor holds ``local_shape``, and a dim
  split over ('pod', 'data') gives each rank the rows the reference's
  ``NamedSharding`` gives the device at the same mesh coordinate.

Tolerance: exact equality (specs, shapes, byte counts)."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from _torch_ranks import PLACEMENT_MESHES, REPO, run_ranks  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs import REGISTRY, get_arch  # noqa: E402
from repro_torch.configs.base import SHAPES, applicable_shapes  # noqa: E402
from repro_torch.launch import dryrun, op_trace  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.steps import (build_cell, param_specs_of,  # noqa: E402
                                      spec_leaves)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.sharding.rules import (DEFAULT_RULES, SP_RULES,  # noqa: E402
                                        local_shape, partition_spec,
                                        tree_specs)


class FakeMesh:
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


# ------------------------------------------------- the reference's cases

def test_partition_spec_basic():
    # with axis size 1, everything falls back to replicated
    spec = partition_spec(MeshShape((1, 1), ("data", "model")),
                          DEFAULT_RULES, ("embed", "mlp"), (64, 256))
    assert spec == ()


def test_rules_override():
    r = DEFAULT_RULES.override(seq_save="model")
    assert r.mesh_axes_for("seq_save") == ("model",)
    assert DEFAULT_RULES.mesh_axes_for("seq_save") == ()
    assert SP_RULES.mesh_axes_for("seq_save") == ("model",)
    assert DEFAULT_RULES.mapping == JR.DEFAULT_RULES.mapping
    assert SP_RULES.mapping == JR.SP_RULES.mapping


def test_divisibility_fallback_logic():
    # 51865 % 16 != 0 -> None; 384 % 16 == 0 -> 'data'
    spec = partition_spec(FakeMesh(), DEFAULT_RULES, ("vocab", "embed"),
                          (51865, 384))
    assert spec == (None, "data")


def test_duplicate_axis_suppression():
    axes = ("kv_cache_batch", "seq_kv", "kv_heads", "kv_cache_head_dim")
    # kv_heads divisible wins, head_dim replicates
    assert partition_spec(FakeMesh(), DEFAULT_RULES, axes,
                          (128, 1024, 32, 128)) == ("data", None, "model")
    # kv_heads NOT divisible -> head_dim takes 'model' instead
    assert partition_spec(FakeMesh(), DEFAULT_RULES, axes,
                          (128, 1024, 8, 128)) == ("data", None, None, "model")


def test_batch_axis_uses_pod_when_present():
    spec = partition_spec(FakePodMesh(), DEFAULT_RULES, ("batch", None, None),
                          (256, 4096, 1024))
    assert spec == (("pod", "data"),)
    assert local_shape(FakePodMesh(), spec, (256, 4096, 1024)) == (8, 4096, 1024)


def test_tree_specs_smoke():
    m = get_arch("llama3.2-1b").model(smoke=True)
    specs = m.param_specs()
    sp = spec_leaves(param_specs_of(FakeMesh(), DEFAULT_RULES, m))
    assert sp and all(isinstance(s, tuple) for s in sp)
    # the leaf rule: axes None or of another rank than the shape replicate
    tree = tree_specs(FakeMesh(), DEFAULT_RULES,
                      {"a": None, "b": ("embed",), "c": ("embed", "mlp")},
                      {"a": torch.empty(32, 64, device="meta"),
                       "b": torch.empty(32, 64, device="meta"),
                       "c": torch.empty(32, 64, device="meta")})
    assert tree == {"a": (), "b": (), "c": ("data", "model")}
    with pytest.raises(ValueError):
        tree_specs(FakeMesh(), DEFAULT_RULES, [("embed",)], specs)


def test_local_shape_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        local_shape(FakeMesh(), ("data",), (24, 8))


def test_meshes_as_data():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.size, one.axis_names) == (
        {"data": 16, "model": 16}, 256, ("data", "model"))
    assert (two.shape, two.size, two.axis_names) == (
        {"pod": 2, "data": 16, "model": 16}, 512, ("pod", "data", "model"))
    with pytest.raises(RuntimeError):       # no process group is up here
        make_mesh((1,), ("data",), device="cpu")


# ------------------------------------ every arch at FULL, leaf for leaf

def _paths(tree, path=()):
    """(path, leaf) of a tree of dicts and lists; tuples are leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _ref_entries(mesh, rules, axes, shape):
    """The reference's spec for one leaf, with its tree_shardings leaf
    rule, as a tuple of entries."""
    if axes is None or len(axes) != len(shape):
        return ()
    return tuple(JR.partition_spec(mesh, rules, axes, tuple(shape)))


@pytest.mark.parametrize("arch_id", sorted(REGISTRY))
def test_full_width_specs_match_the_reference(arch_id):
    port = REGISTRY[arch_id].model(smoke=False, tp_divisor=16)
    ref = JREGISTRY[arch_id].model(smoke=False, tp_divisor=16)
    s = SHAPES["decode_32k"]
    p_specs, r_specs = dict(_paths(port.param_specs())), dict(
        _paths(ref.param_specs()))
    assert p_specs.keys() == r_specs.keys()
    for k, ps in p_specs.items():
        assert (ps.axes, tuple(ps.shape)) == (r_specs[k].axes,
                                              tuple(r_specs[k].shape)), k
    p_cache = port.cache_specs(s.batch, s.seq)
    p_axes = dict(_paths(port.cache_axes()))
    r_axes = dict(_paths(ref.cache_axes()))
    r_shapes = dict(_paths(ref.cache_specs(s.batch, s.seq)))
    assert p_axes == r_axes
    assert {k: tuple(v.shape) for k, v in _paths(p_cache)} == {
        k: tuple(v.shape) for k, v in r_shapes.items()}
    n_split = 0
    for mesh in (FakeMesh(), FakePodMesh()):
        for rules, jrules in ((DEFAULT_RULES, JR.DEFAULT_RULES),
                              (SP_RULES, JR.SP_RULES)):
            got = dict(_paths(param_specs_of(mesh, rules, port)))
            for k, ps in r_specs.items():
                want = _ref_entries(mesh, jrules, ps.axes, ps.shape)
                assert got[k] == want, (k, got[k], want)
                n_split += want != ()
            got = dict(_paths(tree_specs(mesh, rules, port.cache_axes(),
                                         p_cache)))
            for k, ax in r_axes.items():
                want = _ref_entries(mesh, jrules, ax, r_shapes[k].shape)
                assert got[k] == want, (k, got[k], want)
    assert n_split > 0                    # the rules do shard something


# --------------------------------------------------------- the census

_JAX_CENSUS = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import REGISTRY
from repro.configs.base import SHAPES
from repro.launch.steps import build_cell
from repro.sharding.rules import DEFAULT_RULES, SP_RULES

mesh = jax.make_mesh((16, 16), ("data", "model"))
out = {"cells": {}}
for aid, sn in CELLS:
    arch = REGISTRY[aid]
    # the reference dry-run's choice of rules (launch/dryrun.py)
    rules = SP_RULES if SHAPES[sn].kind == "train" else DEFAULT_RULES
    if SHAPES[sn].kind == "decode":
        cfg = getattr(arch.model(smoke=False), "cfg", None)
        lm = getattr(cfg, "lm", cfg)
        kvh = getattr(lm, "n_kv_heads", 0)
        if kvh and kvh % mesh.shape.get("model", 1) != 0:
            rules = DEFAULT_RULES.override(heads=None, head_dim="model")
    cell = build_cell(arch, sn, mesh, rules=rules, smoke=False)
    out["cells"][aid + "/" + sn] = {
        "args": cell.arg_local_bytes(),
        "params_total": int(cell.model.param_count()),
        "params_active": int(cell.model.active_param_count())}
m4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
idx = NamedSharding(m4, P(("pod", "data"))).devices_indices_map((8, 3))
out["rows"] = {f"{i},{j}": idx[m4.devices[i, j]][0].start
               for i in range(2) for j in range(2)}
print(json.dumps(out))
"""

CENSUS_CELLS = (("llama3.2-1b", "train_4k"),
                ("deepseek-v2-lite-16b", "decode_32k"))


@pytest.fixture(scope="module")
def jax_census():
    """The reference's build_cell on 256 host CPU devices, in a
    subprocess (the device count is fixed at JAX's first use)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=256")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    code = f"CELLS = {CENSUS_CELLS!r}\n" + _JAX_CENSUS
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch_id,shape_name", CENSUS_CELLS)
def test_census_matches_the_reference_arg_bytes(jax_census, arch_id,
                                                shape_name):
    rec = dryrun.run_cell(arch_id, shape_name, make_production_mesh(),
                          "single_pod_16x16", verbose=False)
    want = jax_census["cells"][f"{arch_id}/{shape_name}"]
    assert rec["memory_model"]["args"] == want["args"]
    assert (rec["params_total"], rec["params_active"]) == (
        want["params_total"], want["params_active"])
    s = SHAPES[shape_name]
    tokens = s.batch * s.seq if s.kind == "train" else s.batch
    assert rec["model_flops"] == (6 if s.kind == "train" else 2) * \
        want["params_active"] * tokens
    assert rec["n_devices"] == 256
    assert rec["kind"] == s.kind
    mm = rec["memory_model"]
    if s.kind == "train":
        # f32 grads as the params; the bf16 stash of 16 layers, sequence
        # split over 'model' and batch over 'data'
        assert mm["grads_est"] == want["args"]["params"]
        assert mm["remat_stash_est"] == 16 * (256 // 16) * (4096 // 16) * 2048 * 2
    else:
        assert mm["grads_est"] == mm["remat_stash_est"] == 0


def test_census_without_a_mesh_counts_every_byte():
    """A (1, 1) mesh splits nothing: the census equals the mesh-less
    cell's bytes, the f32 params, and AdamW's two f32 moments plus its
    int32 step."""
    arch = get_arch("llama3.2-1b")
    plain = build_cell(arch, "train_4k", device="meta").arg_local_bytes()
    rec = dryrun.run_cell("llama3.2-1b", "train_4k",
                          MeshShape((1, 1), ("data", "model")), "host",
                          verbose=False)
    assert rec["memory_model"]["args"] == plain
    n = sum(math.prod(s.shape) for s in tree_leaves(arch.model().param_specs()))
    assert plain["params"] == 4 * n and plain["opt"] == 8 * n + 4
    assert rec["n_devices"] == 1


def test_cell_rules_follow_the_reference():
    mesh = make_production_mesh()
    assert dryrun.cell_rules("llama3.2-1b", "train_4k", mesh) is SP_RULES
    assert dryrun.cell_rules("llama3.2-1b", "prefill_32k", mesh) is DEFAULT_RULES
    # llama3.2-1b has 8 kv heads: decode shards head_dim over 'model'
    r = dryrun.cell_rules("llama3.2-1b", "decode_32k", mesh)
    assert r.mesh_axes_for("heads") == () and r.mesh_axes_for("head_dim") == (
        "model",)


def test_dryrun_main_writes_one_json_per_cell(tmp_path, capsys,
                                              monkeypatch):
    # main traces each cell's step, which takes 1-178 s a whisper cell
    # (smoke widths too: its train_4k at 2x16x16): here every cell's trace
    # is an empty schedule beside the census's argument bytes, and
    # tests/test_torch_step_trace.py holds a real traced cell's keys
    def stub_trace(arch_id, shape_name, mesh, rules=None, **_):
        cell = build_cell(REGISTRY[arch_id], shape_name, device="meta",
                          mesh=mesh, rules=rules)
        return cell, op_trace.StepTrace(arg_bytes=cell.arg_local_bytes())
    monkeypatch.setattr(dryrun, "traced_cell", stub_trace)
    dryrun.main(["--arch", "whisper-tiny", "--mesh", "both",
                 "--out", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    shapes = applicable_shapes(REGISTRY["whisper-tiny"])
    assert names == sorted(f"whisper-tiny__{s}__{m}.json" for s in shapes
                           for m in ("single_pod_16x16", "multi_pod_2x16x16"))
    rec = json.loads((tmp_path / names[0]).read_text())
    assert set(rec) == {"arch", "shape", "mesh", "kind", "n_devices",
                        "memory_model", "params_total", "params_active",
                        "model_flops", "cost", "collectives", "ops",
                        "trace_s"}
    assert set(rec["memory_model"]) == {"args", "grads_est",
                                        "remat_stash_est", "transient_top4",
                                        "liveness_peak", "total"}
    (tmp_path / names[0]).write_text("{}")
    dryrun.main(["--arch", "whisper-tiny", "--mesh", "both", "--out",
                 str(tmp_path), "--skip-existing", "--no-sp"])
    assert (tmp_path / names[0]).read_text() == "{}"
    assert "all dry-run cells traced OK" in capsys.readouterr().out


# ------------------------------------------------- DTensor placements

@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    return run_ranks("placements", 4, tmp_path_factory.mktemp("placements"))


def test_placements_give_local_shape(placed):
    """4 gloo ranks distribute every smoke llama leaf by ``placements``
    over (data, model) meshes of 4x1, 1x4 and 2x2: each rank's local
    shape is ``local_shape``'s, and some leaves do split."""
    for rank in placed:
        for dims in PLACEMENT_MESHES:
            tag = "x".join(map(str, dims))
            assert (rank[f"got_{tag}"] == rank[f"want_{tag}"]).all(), tag
            assert int(rank[f"split_{tag}"]) > 0, tag


def test_placements_order_shards_as_the_reference(placed, jax_census):
    got = {",".join(map(str, r["coord"].tolist())): int(r["first_row"])
           for r in placed}
    assert got == jax_census["rows"]


# ------------------------------------------- the census against the trainer

def test_census_counts_what_the_trainer_allocates():
    """On a (1, 1) mesh the census's params and AdamW bytes of a train
    cell are what ``build_trainer``'s state holds after a step (phase 14
    holds the FULL llama3.2-1b to phase 11's state on the card)."""
    from repro_torch.launch.train import build_trainer
    init_state, step_fn, _ = build_trainer("llama3.2-1b", smoke=True,
                                           device="cpu", seq_len=16, batch=2)
    state, _ = step_fn(init_state(), 0)
    held = {k: sum(t.numel() * t.element_size() for t in tree_leaves(state[k]))
            for k in ("params", "opt")}
    cell = build_cell(get_arch("llama3.2-1b"), "train_4k", device="meta",
                      mesh=MeshShape((1, 1), ("data", "model")), smoke=True)
    args = cell.arg_local_bytes()
    assert {k: args[k] for k in held} == held


def test_chip_smoke_census_helpers():
    """``chip_smoke``'s phase-14 census helpers on two archs: a record for
    each (arch, applicable shape) and mesh, one line a cell, and
    ``mesh_faults`` / ``gather_rows`` at their edges."""
    import importlib.util
    import numpy as np
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    meshes = {"single_pod_16x16": make_production_mesh(),
              "host_1x1": MeshShape((1, 1), ("data", "model"))}
    cells = cs.census_rows(meshes, archs=["llama3.2-1b", "zamba2-2.7b"])
    assert sorted(cells) == sorted(
        (a, s) for a in ("llama3.2-1b", "zamba2-2.7b")
        for s in applicable_shapes(REGISTRY[a]))
    lines = cs.census_lines(cells, 80 * 10**9)
    assert len(lines) == len(cells)
    assert "host_1x1 17.990 GB (fits)" in lines[0]          # llama train_4k
    assert any("(over)" in line for line in lines)          # decode on 1 card
    m = np.zeros((2, 3), bool)
    p = np.ones((2, 3), np.int32)
    assert cs.mesh_faults(m, p, {"a": 1}, (m, p, {"a": 1})) == []
    assert len(cs.mesh_faults(~m, p + 1, {"a": 2}, (m, p, {"a": 1}))) == 3
    assert cs.gather_rows([(5.0, 1, "ncclDevKernel_AllGather_RING_LL"),
                           (3.0, 2, "probe")]) == [
        (5.0, 1, "ncclDevKernel_AllGather_RING_LL")]
    assert cs.gather_rows("not measured") == "not measured"
    assert cs.gather_rows([(3.0, 2, "probe")]).startswith("not seen")
