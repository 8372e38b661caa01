"""Port parity, slice 14: the reference's training and prefill memory
discipline, on the CPU.

- ``RWKV6LM(remat=True)`` and ``Zamba2LM(remat=True)`` recompute each
  layer (Zamba2: each Mamba2 layer and each application of the shared
  block) in the loss's backward: the loss and every gradient leaf equal
  ``remat=False``'s bit for bit, and both match the JAX reference's
  unrolled model and the scanned, rematerialised one its ``build_cell``
  builds for the FULL cells (``scan_layers=True, remat=True``; its
  stacked layer params are the port's list stacked).
- ``build_cell``'s train cells of both families carry ``remat``, and
  ``calibrate._reduced_model`` passes it, as the reference's do.
- ``_chunk_wkv(..., recompute=True)`` recomputes each chunk in the
  backward: its outputs and gradients equal the plain scan's bit for bit.
- On a fake (1, 2) mesh the step traces keep RWKV6's WKV heads, Zamba2's
  SSD heads and MLA's absorbed scores split over ``model``: the largest
  WKV decay buffer of the smoke rwkv6 train step, the largest SSD decay
  of the smoke zamba2 train step and the largest softmax of the smoke
  deepseek-v2-lite prefill are half of the (1, 1) trace's.
- Under remat the modelled train liveness of both families is below the
  same trace's without it (at smoke width, 4 x 128 tokens, where the
  activations outweigh the optimizer's transients).

Tolerances, as ``tests/test_torch_ssm_rwkv_encdec.py``: the loss within
1e-6 relative; each gradient leaf within 5e-5 of its largest element.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import calibrate, dryrun, hbm_model, steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.rwkv6 import _chunk_wkv  # noqa: E402
from test_torch_ssm_rwkv_encdec import _close, _keyed, _np_params  # noqa: E402

FAMILIES = ["rwkv6-7b", "zamba2-2.7b"]
# each family's weight seed, as ``tests/test_torch_ssm_rwkv_encdec.py``
# draws them: rwkv6's seed-0 weights decay so fast that the reference's
# ``_chunk_wkv`` overflows to NaN (ROADMAP.md, Queue 3), where the port's
# stays finite
SEEDS = {"zamba2-2.7b": 0, "rwkv6-7b": 1}


@pytest.fixture(autouse=True)
def _port_f32_compute():
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    yield
    C.set_compute_dtype(was)


def _stacked(tree):
    """The reference's scanned params of the port's ``tree``: its layer
    list stacked leaf by leaf on a leading layer axis."""
    return {**tree, "layers": jax.tree.map(lambda *ls: np.stack(ls),
                                           *tree["layers"])}


@pytest.fixture(scope="module")
def remat_runs():
    """Per family: the smoke model's loss and gradients with remat off
    and on, from one set of numpy weights and one (2, 32) batch (two
    chunks of the smoke chunk 16), and the weights and batch."""
    out = {}
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    try:
        for i, arch in enumerate(FAMILIES):
            tree = _np_params(get_arch(arch).model(smoke=True), SEEDS[arch])
            toks = np.random.default_rng(10 + i).integers(
                0, 500, (2, 33)).astype(np.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            runs = {}
            for remat in (False, True):
                m = get_arch(arch).model(smoke=True, remat=remat)
                assert m.remat is remat
                runs[remat] = steps.loss_and_grads(
                    m, C.params_from_numpy(tree, "cpu"),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
            out[arch] = (runs, tree, batch)
    finally:
        C.set_compute_dtype(was)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_bits_and_matches_jax(arch, remat_runs):
    """The loss and every gradient leaf with ``remat=True`` equal
    ``remat=False``'s bit for bit, and both match ``jax.value_and_grad``
    of the reference's smoke model (unrolled)."""
    runs, tree, batch = remat_runs[arch]
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    leaves0, leaves1 = C.tree_leaves(g0), C.tree_leaves(g1)
    assert len(leaves0) == len(leaves1) == len(C.tree_leaves(tree))
    assert all(torch.equal(a, b) for a, b in zip(leaves0, leaves1))
    jm = jax_get_arch(arch).model(smoke=True)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l1) - float(jl)) <= 1e-6 * abs(float(jl))
    want = _keyed(jax.tree.map(np.asarray, jg))
    got = _keyed(g1)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], rel=5e-5, what=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_matches_the_scanned_reference(arch, remat_runs):
    """The reference as its ``build_cell`` builds the FULL cells
    (``scan_layers=True, remat=True``) at smoke width, from the port's
    weights with the layers stacked: its loss and gradients (each
    layer's slice of the stacked ones) match the port's remat run."""
    runs, tree, batch = remat_runs[arch]
    loss, grads = runs[True]
    jm = jax_get_arch(arch).model(smoke=True, scan_layers=True, remat=True)
    assert jm.scan and jm.remat
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _stacked(tree)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    jg = jax.tree.map(np.asarray, jg)
    n = len(tree["layers"])
    want = _keyed({**jg, "layers": [jax.tree.map(lambda a, i=i: a[i],
                                                  jg["layers"])
                                     for i in range(n)]})
    got = _keyed(grads)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], rel=5e-5, what=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_build_cell_and_calibrate_pass_remat(arch):
    """``build_cell``'s train cell builds the family with ``remat`` (its
    default, as the reference's), ``remat=False`` turns it off, and
    ``calibrate._reduced_model`` remats the train cells only, as the
    reference's."""
    a = get_arch(arch)
    cell = steps.build_cell(a, "train_4k", device="meta", smoke=True)
    assert cell.model.remat is True
    off = steps.build_cell(a, "train_4k", device="meta", smoke=True,
                           remat=False)
    assert off.model.remat is False
    for kind, want in (("train", True), ("prefill", False)):
        m = calibrate._reduced_model(a, 2, 1, kind)
        assert type(m) is type(cell.model) and m.remat is want
        assert m.cfg.n_layers == 2


@pytest.mark.parametrize("decay", [-0.05, -3.0])
def test_chunk_wkv_recompute_gives_the_same_bits(decay):
    """``_chunk_wkv`` with each chunk recomputed in the backward: y, the
    state and the gradients of every input equal the plain scan's bit
    for bit (4 chunks of 16; a mild and a strong decay)."""
    rng = np.random.default_rng(0)
    B, S, H, dh = 2, 64, 2, 8
    arrays = [rng.normal(size=(B, S, H, dh)).astype(np.float32)
              for _ in range(3)]
    arrays.append((decay * np.exp(rng.normal(size=(B, S, H, dh)) * 0.3)
                   ).astype(np.float32))
    arrays.append(rng.normal(size=(H, dh)).astype(np.float32))
    arrays.append(rng.normal(size=(B, H, dh, dh)).astype(np.float32))
    outs = []
    for recompute in (False, True):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        y, s = _chunk_wkv(*ins, 16, recompute)
        outs.append((y, s, torch.autograd.grad((y * y).sum() + s.sum(), ins)))
    (y0, s0, g0), (y1, s1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _largest(trace, name: str, ndim: int) -> int:
    """The bytes of the largest value an op named ``name`` defines with
    ``ndim`` dims (``op_trace``'s shape text: ``f32[a,b,...]``)."""
    return max(b for op in trace.ops if op.name == name
               for _, b, shape in op.defs if shape.count(",") == ndim - 1)


@pytest.mark.parametrize("arch,shape,name,ndim", [
    ("rwkv6-7b", "train_4k", "aten.exp.default", 5),
    ("zamba2-2.7b", "train_4k", "aten.exp.default", 4),
    ("deepseek-v2-lite-16b", "prefill_32k", "aten._softmax.default", 4)],
    ids=["wkv-decays", "ssd-gammas", "mla-scores"])
def test_heads_stay_split_over_model(arch, shape, name, ndim):
    """The smoke step's trace on a fake (1, 2) mesh under the dry-run's
    rules: its largest WKV decay buffer ([B,T,T,H,dh], every layer and
    the remat recompute), SSD decay ([B,T,T,H]) or absorbed-score
    softmax ([B,H,S,Tc]) is half of the (1, 1) trace's: each ``model``
    rank holds its own heads."""
    got = {dims: _largest(dryrun.traced_cell(
        arch, shape, MeshShape(dims, ("data", "model")), smoke=True)[1],
        name, ndim) for dims in ((1, 1), (1, 2))}
    assert got[(1, 1)] > 0 and 2 * got[(1, 2)] == got[(1, 1)]


def _resized_train(batch: int, seq: int):
    """A wrap for ``dryrun.traced_cell``: the train cell's batch made
    again at ``batch`` x ``seq`` tokens, params and AdamW as they are."""
    def wrap(cell):
        t = torch.empty((batch, seq), dtype=torch.int32, device="meta")
        tree = {"tokens": t, "labels": t}
        specs = steps.batch_specs(cell.mesh, dryrun.cell_rules(
            cell.arch_id, "train_4k", cell.mesh), tree)
        return dataclasses.replace(
            cell, abstract_args=cell.abstract_args[:2] + (tree,),
            arg_specs=cell.arg_specs[:2] + (specs,))
    return wrap


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_lowers_the_train_liveness(arch):
    """The modelled liveness peak (``hbm_model``) of the smoke train step
    at 4 x 128 tokens on (1, 1): with remat below that without it, and
    the argument bytes the same."""
    got = {}
    for remat in (False, True):
        m = get_arch(arch).model(smoke=True, remat=remat)
        _, tr = dryrun.traced_cell(arch, "train_4k",
                                   MeshShape((1, 1), ("data", "model")),
                                   smoke=True, model=m,
                                   wrap=_resized_train(4, 128))
        got[remat] = (tr.arg_bytes, hbm_model.peak_hbm_bytes(tr))
    assert got[True][0] == got[False][0]
    assert got[True][1] < got[False][1]


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_remat_helpers_on_the_cpu():
    """``chip_smoke``'s phase-17 helpers at smoke width on the CPU:
    ``remat_pair`` (rwkv6, 2 layers, 2 x 32 tokens) finds the remat,
    plain and second remat steps equal bit for bit, so ``remat_faults``
    finds nothing, and a planted difference, unequal losses or a remat
    peak not below the plain one each fail it; ``remat_train_faults``
    holds the loss of step 0's batch after the run below step 0's, every
    loss finite; ``remat_traces`` (zamba2, 4 x 128 tokens)
    traces the trainer's step with remat and without: both argument
    bytes are ``build_trainer``'s params and AdamW allocation, and the
    liveness with remat is below that without."""
    from repro_torch.launch import train
    cs = _chip_smoke()
    pair = cs.remat_pair("cpu", smoke=True, n_layers=2, batch=2, seq=32)
    assert pair["loss_equal"] and pair["differ"] == []
    assert pair["leaves"] == len(C.tree_leaves(
        cs.cut_model(cs.REMAT_RWKV, 2).param_specs()))
    assert cs.remat_faults(pair) == []
    assert len(cs.remat_faults(dict(pair, differ=[3], max_diff=2.0**-10,
                                    loss_equal=False))) == 2
    assert len(cs.remat_faults(dict(pair, peak_gb=[1.0, 2.0, 2.0]))) == 1
    assert cs.remat_faults(dict(pair, peak_gb=[1.0, 2.0, 1.5])) == []
    assert cs.remat_train_faults([10.9, 10.8, 10.95], 10.8) == []
    assert cs.remat_train_faults([10.9, 10.8, 10.7], 10.9)
    assert cs.remat_train_faults([10.9, float("nan"), 10.7], 10.0)
    recs = cs.remat_traces(smoke=True, batch=4, seq=128)
    init_state, _, m = train.build_trainer(cs.REMAT_ARCH, smoke=True,
                                           device="cpu")
    state = init_state()
    held = {k: sum(a.numel() * a.element_size()
                   for a in C.tree_leaves(state[k])) for k in ("params", "opt")}
    assert m.remat and [r["remat"] for r in recs] == [True, False]
    for r in recs:
        assert {k: r["arg_bytes"][k] for k in held} == held
    assert recs[0]["liveness"] < recs[1]["liveness"]
