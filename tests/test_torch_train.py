"""Port parity, the training path's model and steps: ``softmax_xent``, the
embedding's VJP, ``TransformerLM.loss`` and its gradients (remat on and
off), ``build_cell``'s inputs and one train step, five ``build_trainer``
steps, against the JAX package on the CPU from carried state; the entry
point, the refusals, and ``chip_smoke``'s phase-11 helpers at smoke
width. Compute in f32 on both sides, but for the embedding's bf16 case.
Tolerances: the loss within 1e-6 relative and gradient leaves within 1e-5
relative L2 (the same f32 arithmetic in another summation order); one
step's params, m, v and grad_norm within 1e-5; the trainer's losses within
1e-5 relative; the embedding's gradient, dtypes, steps and byte counts
equal."""
import dataclasses
import functools
import importlib.util
import inspect
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_step as jax_adamw_step  # noqa: E402
from repro_torch.configs import get_arch, input_specs  # noqa: E402
from repro_torch.configs.llama3_2_1b import SMOKE  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_f32_compute():
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    yield
    C.set_compute_dtype(was)


def _keyed(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts and lists (either package)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _keyed(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _keyed(sub, f"{prefix}/{i}").items()}
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _rel_l2(a, b):
    return np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()),
                                                 1e-30)


def _np_params(m, seed):
    """Numpy weights for ``m``'s specs, drawn as ``init_from_specs`` draws
    them (normal of std ``scale / sqrt(fan_in)``, ones, zeros): no JAX
    random program to compile."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale / np.sqrt(max(1, spec.shape[0]))
        return (rng.normal(size=spec.shape) * std).astype(np.float32)
    return C.tree_map(one, m.param_specs())


def _zero_opt(np_params):
    return {"m": C.tree_map(np.zeros_like, np_params),
            "v": C.tree_map(np.zeros_like, np_params), "step": np.int32(0)}


def _carried_opt(np_params, step=10):
    """An AdamW state to continue from, v > 0: the update is then a smooth
    function of the gradient. From zero moments the first update is
    lr * g / (|g| + eps), which moves by up to 2 lr where |g| is near eps
    and two summation orders differ in its last bits."""
    m = C.tree_map(lambda p: np.float32(0.01) * p, np_params)
    return {"m": m, "v": C.tree_map(lambda a: np.float32(1e-6) + a * a, m),
            "step": np.int32(step)}


def _smoke_pair(remat=True, seed=0):
    """The smoke llama of both packages, the JAX params and their copy."""
    jm = jax_get_arch(ARCH).model(smoke=True, remat=remat)
    m = get_arch(ARCH).model(smoke=True, remat=remat)
    tree = _np_params(m, seed)
    return jm, jax.tree.map(jnp.asarray, tree), m, C.params_from_numpy(
        tree, "cpu")


@pytest.fixture(scope="module")
def remat_pair():
    """``_smoke_pair()`` and the JAX model's jitted ``value_and_grad(loss)``,
    compiled once for the tests that take a (2, 16) batch without a mask."""
    jm, jp, m, p = _smoke_pair()
    return jm, jp, m, p, jax.jit(jax.value_and_grad(jm.loss))


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("mask", [None, "some", "none"],
                         ids=["mean", "masked", "empty-mask"])
def test_softmax_xent_matches_jax(mask):
    rng = np.random.default_rng(0)
    lg = (rng.normal(size=(2, 5, 33)) * 3).astype(np.float32)
    lab = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mk = None if mask is None else (rng.random((2, 5)) < 0.6) * (mask == "some")
    want = JC.softmax_xent(jnp.asarray(lg), jnp.asarray(lab),
                           None if mk is None else jnp.asarray(mk))
    got = C.softmax_xent(torch.from_numpy(lg), torch.from_numpy(lab),
                         None if mk is None else torch.from_numpy(mk))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gradient_matches_jax_vjp(dtype):
    """The custom VJP: rows in the compute dtype; the gradient accumulated
    in ``dx``'s dtype, in token order, then cast to the table's f32 — equal
    to the reference's at f32 and at bf16. At bf16 it is not autograd's
    own gradient of the gather, which accumulates in f32."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(16, 8)).astype(np.float32)
    tokens = rng.integers(0, 3, (3, 7)).astype(np.int32)   # 7 repeats a row
    dx = rng.normal(size=(3, 7, 8)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    was = JC.COMPUTE_DTYPE
    JC.set_compute_dtype(jdt)
    C.set_compute_dtype(tdt)
    try:
        jout, vjp = jax.vjp(lambda t: JC.embed_lookup(t, jnp.asarray(tokens)),
                            jnp.asarray(table))
        (jgrad,) = vjp(jnp.asarray(dx).astype(jdt))
        t = torch.from_numpy(table).requires_grad_(True)
        out = C.embed_lookup(t, torch.from_numpy(tokens))
        (grad,) = torch.autograd.grad(out, t, torch.from_numpy(dx).to(tdt))
        plain = torch.nn.functional.embedding(torch.from_numpy(tokens), t)
        (plain_grad,) = torch.autograd.grad(plain.to(tdt), t,
                                            torch.from_numpy(dx).to(tdt))
    finally:
        JC.set_compute_dtype(was)
    assert out.dtype == tdt and grad.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    assert torch.equal(grad, plain_grad) == (dtype == "float32")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_jax(remat, remat_pair):
    """``loss`` (the plain case with a ``loss_mask``) and every gradient
    leaf against ``jax.value_and_grad(m.loss)`` from the same weights."""
    toks = _tokens(3, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if remat:
        jm, jp, m, p, value_and_grad = remat_pair
    else:
        jm, jp, m, p = _smoke_pair(remat=False)
        value_and_grad = jax.jit(jax.value_and_grad(jm.loss))
        batch["loss_mask"] = np.random.default_rng(4).random((2, 16)) < 0.7
    jl, jg = value_and_grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = steps.loss_and_grads(
        m, p, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    want, got = _keyed(jax.tree.map(np.asarray, jg)), _keyed(grads)
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        assert _rel_l2(g, want[key]) <= 1e-5, key


def test_build_cell_train_step_matches_jax():
    """One ``build_cell("train_4k", smoke=True)`` step (remat, q_chunk
    512) against the reference's cell on the host mesh from the same
    params and a carried AdamW state (``_carried_opt``): new params, m, v,
    step and grad_norm."""
    jcell = JS.build_cell(jax_get_arch(ARCH), "train_4k", make_host_mesh(),
                          smoke=True, donate=False)
    cell = steps.build_cell(get_arch(ARCH), "train_4k", device="cpu",
                            smoke=True)
    assert (cell.kind, cell.model.remat, cell.model.q_chunk) == \
        ("train", True, 512)
    np_p = _np_params(cell.model, 2)
    jp, jo = (jax.tree.map(jnp.asarray, t) for t in (np_p, _carried_opt(np_p)))
    p = C.params_from_numpy(np_p, "cpu")
    o = C.params_from_numpy(_carried_opt(np_p), "cpu")
    toks = _tokens(5, (2, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp2, jo2, jmet = jcell.jitted(jp, jo,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    p2, o2, met = cell.step(p, o, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    for got, want in ((p2, jp2), (o2["m"], jo2["m"]), (o2["v"], jo2["v"])):
        want = _keyed(jax.tree.map(np.asarray, want))
        for key, a in _keyed(got).items():
            np.testing.assert_allclose(a, want[key], **TOL, err_msg=key)
    assert o2["step"].dtype == torch.int32
    assert int(o2["step"]) == int(jo2["step"]) == 11
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6)


def _check_serving_step(cell):
    """A serving cell's step on real tensors of its abstract inputs' shapes
    gives what the model's own entry point gives, outside autograd."""
    m = cell.model
    p = C.init_from_specs(m.param_specs(), torch.Generator().manual_seed(0),
                          "cpu")
    if cell.kind == "prefill":
        toks = torch.from_numpy(_tokens(8, cell.abstract_args[1]["tokens"].shape))
        lg, cache = cell.step(p, {"tokens": toks})
        want, _ = m.prefill(p, {"tokens": toks}, toks.shape[1])
        assert cache["len"] == toks.shape[1]
    else:
        tokens = cell.abstract_args[2]
        B, S = tokens.shape[0], cell.abstract_args[1]["layers"][0]["k"].shape[1]
        cache = {"layers": m.empty_caches(B, S, device="cpu"), "len": 3}
        toks = torch.from_numpy(_tokens(9, tuple(tokens.shape)))
        lg, new = cell.step(p, cache, toks)
        want, _ = m.decode_step(p, cache, toks)
        assert new["len"] == 4
    assert torch.equal(lg, want) and lg.is_inference()


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_cell_inputs_match_jax(shape_name, smoke):
    """``input_specs`` (meta tensors) and ``Cell.arg_local_bytes`` equal
    the reference's ShapeDtypeStructs and byte counts on the host mesh,
    at smoke and full width (bf16 weights for serving, f32 params and
    AdamW state for training)."""
    jcell = JS.build_cell(jax_get_arch(ARCH), shape_name, make_host_mesh(),
                          smoke=smoke)
    cell = steps.build_cell(get_arch(ARCH), shape_name, device="cpu",
                            smoke=smoke)
    assert cell.kind == jcell.kind
    assert cell.arg_local_bytes() == jcell.arg_local_bytes()
    if smoke and cell.kind != "train":
        _check_serving_step(cell)
    got = input_specs(get_arch(ARCH), shape_name, smoke=smoke)
    want = jax_input_specs(jax_get_arch(ARCH), shape_name, smoke=smoke)
    part = "batch" if "batch" in want else "tokens"
    g = got[part] if part == "batch" else {"tokens": got["tokens"]}
    w = want[part] if part == "batch" else {"tokens": want["tokens"]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1], v.device.type)
            for k, v in g.items()} == \
        {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in w.items()}


def test_trainer_matches_jax_from_a_carried_state():
    """Five ``build_trainer`` steps (its pipeline, dedup and train step)
    against the JAX trainer's from one state carried into both packages
    by ``params_from_numpy`` (params and the AdamW state)."""
    _, jstep, _ = JT.build_trainer(ARCH, smoke=True)
    _, step_fn, m = train.build_trainer(ARCH, smoke=True, device="cpu")
    np_p = _np_params(m, 7)
    carried = {"params": np_p, "opt": _zero_opt(np_p),
               "step_count": np.zeros((), np.int64)}
    js = jax.tree.map(jnp.asarray, carried)
    state = {"params": C.params_from_numpy(carried["params"], "cpu"),
             "opt": C.params_from_numpy(carried["opt"], "cpu"),
             "step_count": carried["step_count"]}
    assert state["opt"]["step"].dtype == torch.int32
    for s in range(5):
        js, want = jstep(js, s)
        state, got = step_fn(state, s)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(state["step_count"]) == int(js["step_count"]) == 5
    assert int(state["opt"]["step"]) == 5


def test_train_cli_runs(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: 30 steps with a
    failure injected at step 13 (resumed from step 10's checkpoint), the
    reference's ``[train]`` line, the loss improving, the compute dtype
    restored."""
    res = train.main(["--device", "cpu", "--steps", "30", "--save-every",
                      "10", "--fail-at", "13", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.splitlines()[0]
    assert (res.n_restarts, res.final_step, len(res.losses)) == (1, 30, 33)
    assert res.losses[10:13] == res.losses[13:16]       # steps 10-12 replayed
    assert line.startswith(f"[train] arch={ARCH} steps=30 restarts=1 loss "
                           f"{res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
                           f"wall=")
    assert res.losses[-1] < res.losses[0]
    assert C.COMPUTE_DTYPE == torch.float32


@pytest.mark.parametrize("what", ["scan", "vlm-scan", "zamba2-2.7b"])
def test_unported_training_configs_are_refused(what):
    """The training path refuses what the port does not have: scanned
    layers (with remat; a VLM's backbone asked to scan, through
    ``build_cell``; and the SSM hybrid's and RWKV6's layers, which
    ``build_trainer`` of zamba2-2.7b otherwise builds). Both take
    ``remat``, off by default as in the reference, in its unrolled
    form."""
    if what == "scan":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TransformerLM(SMOKE, remat=True, scan_layers=True)
        return
    if what == "vlm-scan":
        arch = get_arch("internvl2-26b")
        arch = dataclasses.replace(arch, make_model=lambda smoke, tp, **kw:
                                   get_arch("internvl2-26b").make_model(
                                       smoke, tp, scan_layers=True, **kw))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            steps.build_cell(arch, "train_4k", device="cpu", smoke=True)
        return
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.ssm import Zamba2LM
    for cls, arch_id in ((Zamba2LM, what), (RWKV6LM, "rwkv6-7b")):
        cfg = get_arch(arch_id).model(smoke=True).cfg
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            cls(cfg, scan_layers=True)
        assert inspect.signature(cls).parameters["remat"].default is False
    _, _, m = train.build_trainer(what, smoke=True, device="cpu")
    assert isinstance(m, Zamba2LM)


def test_chip_smoke_train_helpers_on_the_cpu(tmp_path, remat_pair):
    """``chip_smoke``'s phase-11 helpers at smoke width on the CPU: a
    short ``train_run``; ``train_step_parts`` from numpy params and a
    carried AdamW state against the JAX package's loss, gradients and
    AdamW step within phase 11's tolerances; the supervisor with a failure
    at step 6 against an uninterrupted run, no fault, and a broken run
    caught."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    run = cs.train_run("cpu", smoke=True, seq_len=32, batch=2, n_steps=3)
    assert len(run["losses"]) == len(run["ms"]) == 3
    assert cs.train_faults([2.0, 1.5]) == []
    assert cs.train_faults([2.0, 2.5]) and cs.train_faults([2.0, float("nan")])
    assert cs.train_flops(SMOKE, 2, 32)[0] > 0

    _, _, m, _, value_and_grad = remat_pair
    np_p = cs.numpy_params(m.param_specs(), seed=1)
    np_o = cs.carried_opt_state(np_p, step=10)
    toks = _tokens(6, (2, 17))
    loss, grads, new_p = cs.train_step_parts(m, np_p, np_o, toks, "cpu")
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    jp = jax.tree.map(jnp.asarray, np_p)
    jl, jg = value_and_grad(jp, jb)
    jp2, _, _ = jax.jit(functools.partial(jax_adamw_step, JaxAdamWConfig()))(
        jp, jg, jax.tree.map(jnp.asarray, np_o))
    assert abs(loss - float(jl)) / abs(float(jl)) <= cs.TRAIN_LOSS_REL
    keys = list(_keyed(np_p))                   # in tree_leaves order
    jg, jp2 = _keyed(jax.tree.map(np.asarray, jg)), _keyed(
        jax.tree.map(np.asarray, jp2))
    for key, g, p in zip(keys, grads, new_p):
        assert cs.rel_l2(g, jg[key]) <= cs.TRAIN_GRAD_REL, key
        assert cs.rel_l2(p, jp2[key]) <= cs.TRAIN_PARAM_REL, key

    clean = cs.supervised_run("cpu", str(tmp_path / "clean"))
    failed = cs.supervised_run("cpu", str(tmp_path / "failed"),
                               fail_at=cs.SUP_FAIL_AT)
    assert cs.supervisor_faults(failed, clean) == []
    assert len(failed["res"].losses) == cs.SUP_STEPS + 2
    failed["n_dropped"] += 4          # the reference's replayed documents
    failed["res"].losses[-1] += 1e-7
    assert [f.split(" ")[0] for f in cs.supervisor_faults(failed, clean)] == [
        "losses", "documents"]
