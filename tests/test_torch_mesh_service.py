"""Port parity, slice 11: ``FilterService(mesh=)``, the row split of the
filter bank over the ``data`` ranks of a ``DeviceMesh``, on the CPU.

Two gloo ranks (``tests/_torch_ranks.py``, each a subprocess over a
``FileStore``) serve a bank of the five serving filter kinds, built as
``kernels/selfcheck.filter_case`` builds them, and probe 3,001 queries
and an empty batch. Every rank's member and probes rows, its
``probe_filter`` rows and its stats must equal the one-device
``FilterService(device="cpu")`` and the JAX package's one-device
``FilterService`` (Pallas interpret mode); an ``LsmStore(mesh=)``'s
``service.probe``, which the mesh splits, must equal the one-device
store's, and its ``get_batch`` (whose ``lsm_probe`` the mesh does not
split) must answer as the one-device store does. In process:
``row_share`` against the JAX service's padding of key rows. Tolerance:
exact equality (integer and boolean outputs, integer-derived stats)."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import _torch_ranks as R  # noqa: E402
from repro.core import hashing as JH  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.bloomier import ExactBloomier as JExact  # noqa: E402
from repro.core.bloomier import XorFilter as JXor  # noqa: E402
from repro.core.chained import ChainedFilterAnd as JAnd  # noqa: E402
from repro.core.chained import ChainedFilterCascade as JCascade  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.serving.filter_service import FilterService as JService  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402
from repro_torch.serving import FilterService  # noqa: E402
from repro_torch.serving.filter_service import row_share  # noqa: E402
from repro_torch.storage import LsmStore  # noqa: E402


def _ref_filters():
    """The bank of ``R.bank_case`` built by the JAX package: what
    ``selfcheck.filter_case`` builds for each of ``R.BANK_CASES``."""
    per, s = R.BANK_PER, selfcheck.FILTER_SEED
    keys = JH.random_keys(per * 10 + 8, seed=R.BANK_SEED)
    pos, neg = keys[:per], keys[per:9 * per]
    depth = R.BANK_CASES[4][1]
    layers = [JBloom.build(pos[:max(16, math.ceil(per * 0.8 ** i))], 0.3,
                           seed=s + 977 * i) for i in range(depth)]
    return [JBloom.build(pos, 0.01, seed=s + 2),
            JXor.build(pos, 8, mode="fuse", seed=s + 8),
            JExact.build(pos, neg[:2 * per], strategy="a", seed=s),
            JAnd.build(pos, neg[:8 * per], seed=s, eps=0.0),
            JCascade(layers=layers, n_pos=per, n_neg=0)]


@pytest.fixture(scope="module")
def one_device():
    """The port's and the JAX package's one-device services over the
    bank, each probed with the 3,001 queries and then none."""
    filters, q = R.bank_case()
    port, ref = FilterService(filters, device="cpu"), JService(_ref_filters())
    assert port.bank.tables.tobytes() == ref.bank.tables.tobytes()
    out = {}
    for name, svc in (("port", port), ("ref", ref)):
        res = {n: svc.probe(q[:n]) for n in (R.N_QUERIES, 0)}
        res["filter"] = [svc.probe_filter(i, q) for i in range(len(filters))]
        res["stats"] = svc.stats.as_dict()
        out[name] = res
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("service", 2, tmp_path_factory.mktemp("service"))


@pytest.mark.parametrize("n", [R.N_QUERIES, 0])
def test_mesh_probe_matches_one_device_and_the_reference(ranks, one_device, n):
    for want in (one_device["port"][n], one_device["ref"][n]):
        for rank in ranks:
            np.testing.assert_array_equal(rank[f"member_{n}"], want[0])
            np.testing.assert_array_equal(rank[f"probes_{n}"], want[1])
            assert rank[f"member_{n}"].shape == (5, n)


def test_mesh_stats_equal_one_device(ranks, one_device):
    """The stats count the gathered rows, padding excluded: every rank's
    equal the one-device services'."""
    for want in (one_device["port"]["stats"], one_device["ref"]["stats"]):
        for rank in ranks:
            assert int(rank["lookups"]) == want["lookups"] == R.N_QUERIES
            assert rank["hits"].tolist() == want["hits"]
            np.testing.assert_array_equal(
                rank["sum_probes"] / R.N_QUERIES, want["avg_probes"])


def test_mesh_probe_filter_matches(ranks, one_device):
    for rank in ranks:
        np.testing.assert_array_equal(rank[f"filter_{R.N_QUERIES}"],
                                      np.stack(one_device["port"]["filter"]))
        np.testing.assert_array_equal(rank[f"filter_{R.N_QUERIES}"],
                                      np.stack(one_device["ref"]["filter"]))
        assert rank["filter_0"].shape == (5, 0)


def test_mesh_store_matches_the_one_device_store(ranks):
    """The mesh splits the store's bank probes (``service.probe``), held
    here row for row; ``get_batch`` reads through ``lsm_probe`` on the
    whole batch on every rank, so its equality does not test the split."""
    keys = R.store_keys()
    store = LsmStore(filter_kind="chained", seed=1, memtable_capacity=2**62,
                     auto_compact=False, device="cpu")
    for i in range(3):
        ks = keys[i * 1500:(i + 1) * 1500]
        store.put_batch(ks, ks >> np.uint64(7))
        store.flush()
    found, vals, reads = store.get_batch(keys)
    member, probes = store.service.probe(keys)
    assert found[:4500].all() and not found[4500:].any()
    for rank in ranks:
        np.testing.assert_array_equal(rank["found"], found)
        np.testing.assert_array_equal(rank["vals"], vals)
        np.testing.assert_array_equal(rank["reads"], reads)
        np.testing.assert_array_equal(rank["store_member"], member)
        np.testing.assert_array_equal(rank["store_probes"], probes)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_row_share_is_the_reference_padding(world):
    """The JAX service pads a batch to whole (8, 128) blocks and then to
    whole row groups of BLOCK_ROWS x devices; each device probes an equal
    share of the rows. ``row_share`` gives each rank the same count."""
    ref = types.SimpleNamespace(_row_multiple=JC.BLOCK_ROWS * world)
    for n in (1, 1023, 1024, 1025, 3001, 4096 * world + 1, 20_000):
        keys = np.arange(1, n + 1, dtype=np.uint64)
        hi2d, _, n_valid = JService._block_keys(ref, keys)
        assert n_valid == n
        assert hi2d.shape[0] % world == 0
        assert row_share(n, world) == hi2d.shape[0] // world * JC.BLOCK_COLS
    assert row_share(0, world) == 0


def test_a_mesh_of_another_device_is_refused():
    fake = types.SimpleNamespace(device_type="cuda", mesh_dim_names=("data",))
    filters, _ = R.bank_case()
    with pytest.raises(ValueError):
        FilterService(filters[:1], device="cpu", mesh=fake)
    fake.device_type = "cpu"
    fake.mesh_dim_names = ("model",)
    with pytest.raises(ValueError):
        FilterService(filters[:1], device="cpu", mesh=fake)


# ------------------------------------------- chip_smoke's phase 14 on the CPU
def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture
def smoke_phase(monkeypatch):
    """chip_smoke's phase 14 with its card-only calls stubbed: the device
    synchronise and memory counters, the CUDA-event and profiler timers
    (each still calls what it times once). -> (module, its arguments)."""
    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=80e9))

    def once(fn):
        fn()
        return 0.0, []
    monkeypatch.setattr(cs, "cuda_ms", once)
    monkeypatch.setattr(cs, "device_rows",
                        lambda fn: once(fn) and "not measured (CPU)")
    filters, q = R.bank_case()
    svc = FilterService(filters, device="cpu")
    member, probes = svc.probe(q)
    want = (member, probes, svc.stats.as_dict())
    # phase 11's allocation of the FULL llama3.2-1b params and AdamW state
    from repro_torch.configs import get_arch
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.adamw import adamw_init
    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"),
                      get_arch(cs.LM_ARCH).model().param_specs())
    state = {"params": params, "opt": adamw_init(params)}
    train = {k: sum(a.numel() * a.element_size() for a in tree_leaves(v))
             for k, v in state.items()}
    seen = []
    kinds = [k for k, _ in R.BANK_CASES]
    counters = types.SimpleNamespace(
        reset=lambda: seen.append("reset"),
        launches=lambda: dict.fromkeys(kinds, 1),
        paths=lambda: {"bloom_probe": {"onchip": 1, "gather": 0}},
        rule=lambda n, words: seen.append((n, words.numel())) or
        {"bloom_probe": {"onchip": 1, "gather": 0}})
    return cs, svc, q, want, train, counters, seen


def test_chip_smoke_mesh_phase_on_one_gloo_rank(smoke_phase, capsys):
    """Phase 14 runs whole on a 1-rank gloo group: the mesh service equals
    the one-device one, the launches and paths come from the counters,
    the rule is asked at one rank's share of the keys, and the census's
    (1, 1) train bytes equal the params and AdamW state built on meta
    tensors."""
    cs, svc, q, want, train, counters, seen = smoke_phase
    launches, paths = cs.mesh_phase(svc.bank, q, want, train, counters,
                                    device="cpu", card="cpu")
    assert launches == dict.fromkeys([k for k, _ in R.BANK_CASES], 1)
    assert paths == {"bloom_probe": {"onchip": 1, "gather": 0}}
    assert seen == ["reset", (row_share(len(q), 1),
                              svc.bank.tables.size)]
    out = capsys.readouterr().out
    assert f"on all {len(q)} queries" in out
    assert f"census {cs.LM_ARCH} train_4k: args per device" in out
    assert "== phase 11's allocation" in out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("wrong,says", [
    ("member", "member rows differ"), ("stats", "'lookups': 3002"),
    ("train bytes", "phase 11 allocated")])
def test_chip_smoke_mesh_phase_fails_on_a_difference(smoke_phase, capsys,
                                                     wrong, says):
    """A flipped member bit, a stats count one off, or train bytes one
    off fails the phase by its own check, and the group is still
    destroyed."""
    cs, svc, q, want, train, counters, _ = smoke_phase
    member, probes, stats = want
    if wrong == "member":
        member = member.copy()
        member[2, 7] = not member[2, 7]
    elif wrong == "stats":
        stats = dict(stats, lookups=stats["lookups"] + 1)
    else:
        train = dict(train, opt=train["opt"] + 1)
    with pytest.raises(SystemExit):
        cs.mesh_phase(svc.bank, q, (member, probes, stats), train, counters,
                      device="cpu", card="cpu")
    assert says in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_chip_smoke_sharded_phase_on_one_gloo_rank(smoke_phase, capsys):
    """Phase 15 runs whole, at smoke width, after phase 14 in its 1-rank
    gloo group: the sharded train, prefill and decode steps of the llama
    and deepseek-v2-lite smokes equal the one-device steps bit for bit,
    and the placed bytes equal the cell's (the census's row is the
    smoke cell's here)."""
    cs, svc, q, want, train, counters, _ = smoke_phase
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell
    smoke_bytes = build_cell(
        get_arch(cs.LM_ARCH), "train_4k", device="meta", smoke=True,
        mesh=MeshShape((1, 1), ("data", "model"))).arg_local_bytes()
    seen = []
    cs.mesh_phase(svc.bank, q, want, train, counters, device="cpu",
                  card="cpu", then=lambda mesh, census: seen.append(
                      cs.sharded_phase(mesh, {k: smoke_bytes[k] for k in (
                          "params", "opt")}, device="cpu", smoke=True)))
    assert seen == [None]
    out = capsys.readouterr().out
    assert "largest difference from the one-device step {'loss': 0.0" in out
    assert out.count("'params': 0.0, 'm': 0.0, 'v': 0.0, 'step': 0.0") == 2
    assert out.count("{'prefill': 0.0, 'decode': 0.0, 'cache': 0.0}") == 2
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("a,b,want", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.0], [1.0, 2.5], 0.5),
    ([1.0, 2.0], [math.nan, 2.0], math.nan),
    ([1.0, 2.0], [1.5, math.nan], math.nan),
    ([math.nan, 2.0], [math.nan, 2.0], math.nan),
    ([1.0, math.inf], [1.0, math.inf], 0.0),
    ([1.0, 2.0], [1.0, math.inf], math.inf)])
def test_chip_smoke_tree_max_diff_keeps_a_nan(a, b, want):
    """Phase 15's difference of two trees (a leaf a tensor each): a nan in
    either tree is a nan difference wherever it stands, even after a
    finite difference or in both trees at one place, and a nan
    difference is a fault; equal trees differ by 0.0, no fault."""
    cs = _chip_smoke()
    got = cs.tree_max_diff([torch.tensor(x) for x in a],
                           [torch.tensor(x) for x in b])
    np.testing.assert_equal(got, want)
    assert bool(cs.sharded_faults({"t": got})) == (want != 0.0)
    assert math.isnan(cs.worse(math.nan, 1.0))
    assert math.isnan(cs.worse(1.0, math.nan))


@pytest.mark.parametrize("wrong,says", [
    ("loss", "'loss differs by nan'"), ("params", "'params differs by")])
def test_chip_smoke_sharded_phase_fails_on_a_difference(
        smoke_phase, capsys, monkeypatch, wrong, says):
    """A sharded train step whose loss comes back nan, or whose first
    param leaf is 2**-10 off, fails phase 15 by its own check
    (the one-device step's loss is finite), and the group is still
    destroyed."""
    cs, svc, q, want, train, counters, _ = smoke_phase
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.common import tree_leaves, tree_unflatten
    make = S.make_train_step

    def planted(model, cfg, *, mesh=None, **kw):
        step = make(model, cfg, mesh=mesh, **kw)
        if mesh is None:
            return step

        def off(*args):
            p, o, m = step(*args)
            if wrong == "loss":
                return p, o, dict(m, loss=m["loss"] * math.nan)
            leaves = tree_leaves(p)
            return tree_unflatten(p, [leaves[0] + 2.0 ** -10]
                                  + leaves[1:]), o, m
        return off
    monkeypatch.setattr(S, "make_train_step", planted)
    smoke_bytes = S.build_cell(
        get_arch(cs.LM_ARCH), "train_4k", device="meta", smoke=True,
        mesh=MeshShape((1, 1), ("data", "model"))).arg_local_bytes()
    with pytest.raises(SystemExit):
        cs.mesh_phase(svc.bank, q, want, train, counters, device="cpu",
                      card="cpu", then=lambda mesh, census: cs.sharded_phase(
                          mesh, {k: smoke_bytes[k] for k in (
                              "params", "opt")}, device="cpu", smoke=True))
    err = capsys.readouterr().err
    assert f"sharded {cs.LM_ARCH} train step != the one-device step" in err
    assert says in err
    assert not torch.distributed.is_initialized()
