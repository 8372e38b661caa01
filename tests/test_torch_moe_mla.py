"""Port parity, MoE, MLA and the VLM wrapper: ``repro_torch.models.common``'s
``moe_block``, ``TransformerLM``'s MoE and MLA layers (deepseek-v2-lite
and llama4-scout smoke configs), ``models/vlm.py`` (internvl2 smoke) and
their paths through ``ServeEngine``, ``build_trainer``, ``input_specs``,
``build_cell`` and ``launch/serve.py``, on the CPU against the JAX
package from the same numpy inputs. Compute in f32 on both sides, but
for ``moe_block``'s bf16 case.

Tolerances: ``moe_block`` at f32 within 1e-6 (the dispatch is an exact
copy; the combine sums the same k products in another order), its
gradients within 1e-5 relative L2; at bf16 (against the reference at f32
on the same bf16-rounded inputs: JAX's CPU backend has no bf16 dot with
an f32 result) within 2^-7 of the largest output, four roundings to bf16
that the f32 run does not make (silu(h) * u, the experts' output product,
the combine weights, the output) of 2^-9 each; routing (expert ids, kept
pairs) equal. Models: logits
and caches within 1e-5, loss within 1e-6 relative, gradient leaves within
1e-5 relative L2, except a leaf whose gradient is zero in exact arithmetic
(the router at top-1, where the renormalised gate is g / g = 1), held to
1e-6 absolute; the trainer's losses within 1e-5; engine outputs, stats and
input shapes equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.launch import serve as JSERVE  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import get_arch, input_specs  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

MOE_MLA = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
VLM = "internvl2-26b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_f32_compute():
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    yield
    C.set_compute_dtype(was)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _keyed(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts and lists (either package)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _keyed(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _keyed(sub, f"{prefix}/{i}").items()}
    return {prefix: _np(tree)}


def _np_params(m, seed):
    """Numpy weights for ``m``'s specs: normal of std ``1 / sqrt(fan_in)``,
    the norms' gains 1 + N(0, 0.1) (away from 1, so a wrong gain shows)."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.normal(size=spec.shape)).astype(np.float32)
        std = spec.scale / np.sqrt(max(1, spec.shape[0]))
        return (rng.normal(size=spec.shape) * std).astype(np.float32)
    return C.tree_map(one, m.param_specs())


def _pair(arch, seed=0, **kw):
    """The smoke model of both packages, numpy params and both copies."""
    jm = jax_get_arch(arch).model(smoke=True, **kw)
    m = get_arch(arch).model(smoke=True, **kw)
    tree = _np_params(m, seed)
    return jm, jax.tree.map(jnp.asarray, tree), m, C.params_from_numpy(
        tree, "cpu"), tree


def _tokens(seed, shape, vocab=500):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _check_grads(got, want_tree, np_tree):
    """Gradient leaves (port, in ``tree_leaves`` order) against the JAX
    gradient tree, by key."""
    want = _keyed(jax.tree.map(np.asarray, want_tree))
    for key, g in zip(_keyed(np_tree), got):
        g, w = _np(g), want[key]
        diff = np.linalg.norm((g - w).ravel())
        assert diff <= 1e-5 * np.linalg.norm(w.ravel()) or diff <= 1e-6, key


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _moe_case(case):
    """(x [B,S,D], params, kw) numpy for one routing case."""
    rng = np.random.default_rng(["plain", "groups", "overflow", "tie",
                                 "bf16"].index(case))
    B, S, D, F, E, k, gs = 2, 16, 32, 48, 8, 2, 4096
    if case == "groups":
        B, gs = 4, 16                       # T = 64 in 4 groups of 16
    if case in ("overflow", "tie"):
        B, S, E = 4, 16, 4
        k = 2 if case == "overflow" else 1
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "wi_gate": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wi_up": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    if case == "overflow":
        # a constant feature that only expert 0 reads: every token's first
        # choice is expert 0, 64 tokens for its 40 slots
        x[..., 0] = 4.0
        p["router"][0] = [8.0, 0.0, 0.0, 0.0]
    if case == "tie":
        # experts 1 and 2 read the same column: every token ties
        x[..., 0] = 4.0
        p["router"][0] = [0.0, 8.0, 8.0, 0.0]
        p["router"][:, 2] = p["router"][:, 1]
    p = {name: a.astype(np.float32) for name, a in p.items()}
    return x, p, dict(n_experts=E, top_k=k, group_size=gs)


def _spec_keep(gidx, n_groups, n_experts, cap):
    """Pairs kept, by the reference's rule written out: an expert's rows in
    a group fill in flattened (token, choice) order up to ``cap``."""
    T, k = gidx.shape
    keep = np.zeros((T, k), bool)
    Tg = T // n_groups
    for g in range(n_groups):
        seen = np.zeros(n_experts, int)
        for t in range(g * Tg, (g + 1) * Tg):
            for j in range(k):
                e = gidx[t, j]
                keep[t, j] = seen[e] < cap
                seen[e] += 1
    return keep


@pytest.mark.parametrize("case", ["plain", "groups", "overflow", "tie",
                                  "bf16"])
def test_moe_block_matches_jax(case):
    """``moe_block`` against the reference's from the same numpy inputs:
    the expert ids equal ``jax.lax.top_k``'s (ties: the lower id), the kept
    pairs those of the reference's rule, the output within the stated
    tolerance. ``overflow`` drops 24 first choices; ``tie`` routes every
    token to expert 1 of two equal columns."""
    x, p, kw = _moe_case(case)
    dt = "bfloat16" if case == "bf16" else "float32"
    if case == "bf16":
        # JAX's CPU backend has no bf16 x bf16 -> f32 dot: the reference
        # runs at f32 on the inputs and weights rounded to bf16 (the
        # values its casts would give), the port at bf16
        x = np.asarray(jnp.asarray(x, dt), np.float32)
        p = {k: np.asarray(jnp.asarray(v, dt), np.float32)
             for k, v in p.items()}
    jx = jnp.asarray(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax.jit(functools.partial(JC.moe_block, **kw))(jx, jp)
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = C.moe_block(tx, tp, **kw)
    assert got.dtype == tx.dtype
    E, k = kw["n_experts"], kw["top_k"]
    # the reference's routing, as its moe_block computes it
    probs = jax.nn.softmax(jnp.einsum(
        "td,de->te", jx.reshape(-1, x.shape[-1]), jp["router"],
        preferred_element_type=jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(probs, k)
    _, gidx = C.moe_route(tx.reshape(-1, x.shape[-1]), tp["router"], k)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jidx))
    T = x.shape[0] * x.shape[1]
    G, _, cap = C.moe_capacity(T, k, E, group_size=kw["group_size"])
    _, keep = C.moe_slots(gidx, G, E, cap)
    np.testing.assert_array_equal(keep.numpy(),
                                  _spec_keep(gidx.numpy(), G, E, cap))
    if case == "groups":
        assert G == 4
    if case == "overflow":
        assert (T * k - int(keep.sum()), cap) == (T - cap, 40)
    if case == "tie":
        assert (gidx == 1).all()
    if case == "bf16":
        w = _np(want)
        assert np.abs(_np(got) - w).max() <= 2 ** -7 * np.abs(w).max()
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_moe_block_gradient_matches_jax():
    """The gradient of ``sum(moe_block(x) * cot)`` with respect to x and
    every weight (the router's through the renormalised top-2 gates)
    against ``jax.grad``'s, with tokens dropped (the overflow case)."""
    x, p, kw = _moe_case("overflow")
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(x_, p_):
        return jnp.sum(JC.moe_block(x_, p_, **kw) * cot)
    jgx, jgp = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    out = torch.sum(C.moe_block(tx, tp, **kw) * torch.from_numpy(cot))
    grads = torch.autograd.grad(out, [tx, *tp.values()])
    for g, w in zip(grads, [jgx, *(jgp[k] for k in tp)]):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


def test_moe_capacity_refuses_uneven_groups():
    """The reference reshapes T tokens into (G, T // G) and fails where G
    does not divide T; the port raises there and keeps the reference's
    capacity elsewhere (ceil(1.25 * Tg * k / E), at least 32, at most
    Tg * k)."""
    with pytest.raises(ValueError, match="groups of equal size"):
        C.moe_capacity(13, 2, 8, group_size=4)         # G = 3
    assert C.moe_capacity(4096, 6, 64) == (1, 4096, 480)
    assert C.moe_capacity(1, 6, 64) == (1, 1, 6)
    assert C.moe_capacity(64, 6, 64) == (1, 64, 32)
    assert C.moe_capacity(8192, 2, 8, group_size=2048) == (4, 2048, 640)


# ---------------------------------------------------------------------------
# MoE and MLA in TransformerLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_mla_prefill_and_decode_match_jax(arch):
    """Prefill logits and every layer's cache (MLA: the compressed ``ckv``
    and ``krope``), then 3 decode steps, from carried weights."""
    jm, jp, m, p, _ = _pair(arch)
    toks = _tokens(0, (2, 12))
    jl, jc = jax.jit(lambda p_, b: jm.prefill(p_, b, 20))(
        jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)}, 20)
    np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    for jl_, l_ in zip(jc["layers"], c["layers"]):
        assert sorted(l_) == sorted(jl_)
        for k in l_:
            np.testing.assert_allclose(_np(l_[k]), _np(jl_[k]), **TOL)
    jax_decode = jax.jit(jm.decode_step)
    for s in _tokens(1, (3, 2, 1)):
        jl, jc = jax_decode(jp, jc, jnp.asarray(s))
        lg, c = m.decode_step(p, c, torch.from_numpy(s))
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    assert c["len"] == int(jc["len"]) == 15


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_mla_loss_and_gradients_match_jax(arch):
    """``loss`` and its gradient (every leaf: router, stacked experts,
    shared experts, the MLA projections) from carried weights."""
    jm, jp, m, p, tree = _pair(arch, seed=2)
    toks = _tokens(3, (2, 17))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.loss_and_grads(
        m, p, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    _check_grads(C.tree_leaves(grads), jg, tree)


def test_mla_absorbed_prefill_matches_materialised_path():
    """MLA's two forms on the same tokens: the loss's materialised K/V
    (no cache) and prefill's absorbed scores over the compressed cache
    give the same last-position logits, and a decode step the same as
    the materialised path over one more token; a decode step past the
    cache's length raises."""
    _, _, m, p, _ = _pair("deepseek-v2-lite-16b", seed=4)
    toks = torch.from_numpy(_tokens(5, (2, 10)))

    def materialised(t):
        B, S = t.shape
        pos = torch.arange(S)[None, :].expand(B, S)
        x, _ = m._backbone(p, m._embed(p, t), positions=pos)
        return m._logits(p, C.rms_norm(x, p["ln_f"]))[:, -1:]

    lg, cache = m.prefill(p, {"tokens": toks[:, :9]}, 10)
    np.testing.assert_allclose(_np(lg), _np(materialised(toks[:, :9])), **TOL)
    lg, cache = m.decode_step(p, cache, toks[:, 9:])
    np.testing.assert_allclose(_np(lg), _np(materialised(toks)), **TOL)
    # the cache is full: a write past it raises (the reference's
    # dynamic_update_slice would clamp it)
    with pytest.raises(RuntimeError):
        m.decode_step(p, cache, toks[:, 9:])


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_serve_engine_matches_jax(arch):
    """The smoke model through the JAX engine and
    ``ServeEngine(device="cpu")``: a stream with a repeated prompt, equal
    greedy outputs and ``stats()``."""
    jm, jp, m, p, _ = _pair(arch, seed=6)
    jeng = JE.ServeEngine(jm, jp, max_len=32)
    eng = engine.ServeEngine(m, p, max_len=32, device="cpu")
    prompts = _tokens(7, (2, 8))
    got = [engine.Request(rid=i, prompt=prompts[j].copy(), max_new=n)
           for i, (j, n) in enumerate([(0, 4), (1, 3), (0, 4)])]
    want = [JE.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in got]
    eng.run(got)
    jeng.run(want)
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.stats() == jeng.stats()
    assert got[0].output == got[2].output


def test_moe_trainer_matches_jax_from_a_carried_state():
    """Three ``build_trainer("deepseek-v2-lite-16b")`` steps (pipeline,
    dedup, loss and gradient through the MoE dispatch, AdamW) against the
    JAX trainer's from one state carried into both."""
    arch = "deepseek-v2-lite-16b"
    _, jstep, _ = JT.build_trainer(arch, smoke=True)
    _, step_fn, m = train.build_trainer(arch, smoke=True, device="cpu")
    np_p = _np_params(m, 8)
    zeros = {"m": C.tree_map(np.zeros_like, np_p),
             "v": C.tree_map(np.zeros_like, np_p), "step": np.int32(0)}
    js = jax.tree.map(jnp.asarray, {"params": np_p, "opt": zeros,
                                    "step_count": np.zeros((), np.int64)})
    state = {"params": C.params_from_numpy(np_p, "cpu"),
             "opt": C.params_from_numpy(zeros, "cpu"),
             "step_count": np.zeros((), np.int64)}
    for s in range(3):
        js, want = jstep(js, s)
        state, got = step_fn(state, s)
        np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the VLM
# ---------------------------------------------------------------------------

def test_vlm_matches_jax():
    """internvl2 smoke with 8 patch embeddings: ``loss``, prefill logits
    and cache (``len = P + S``), 2 decode steps, from carried weights."""
    jm, jp, m, p, _ = _pair(VLM, seed=9)
    P, D = m.cfg.n_patches, m.cfg.lm.d_model
    pe = np.random.default_rng(10).normal(size=(2, P, D)).astype(
        np.float32) * 0.25
    toks = _tokens(11, (2, 9))
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "patch_embeds": jnp.asarray(pe)}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    np.testing.assert_allclose(float(m.loss(p, tb)),
                               float(jax.jit(jm.loss)(jp, jb)), rtol=1e-6)
    jpre = {"tokens": jb["tokens"], "patch_embeds": jb["patch_embeds"]}
    jl, jc = jax.jit(lambda p_, b: jm.prefill(p_, b, 24))(jp, jpre)
    lg, c = m.prefill(p, {"tokens": tb["tokens"],
                          "patch_embeds": tb["patch_embeds"]}, 24)
    np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    assert c["len"] == int(jc["len"]) == P + 8
    for jl_, l_ in zip(jc["layers"], c["layers"]):
        np.testing.assert_allclose(_np(l_["k"]), _np(jl_["k"]), **TOL)
    jax_decode = jax.jit(jm.decode_step)
    for s in _tokens(12, (2, 2, 1)):
        jl, jc = jax_decode(jp, jc, jnp.asarray(s))
        lg, c = m.decode_step(p, c, torch.from_numpy(s))
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_vlm_cell_inputs_match_jax(shape_name):
    """internvl2's ``input_specs`` (the patch embeddings ``[B, 8, 128]``
    f32 beside the tokens) and ``Cell.arg_local_bytes`` (the prefill
    cache of ``seq + n_patches``) equal the reference's at smoke width;
    the prefill step runs on the CPU from those shapes."""
    jcell = JSTEPS.build_cell(jax_get_arch(VLM), shape_name,
                              make_host_mesh(), smoke=True)
    cell = steps.build_cell(get_arch(VLM), shape_name, device="cpu",
                            smoke=True)
    assert cell.arg_local_bytes() == jcell.arg_local_bytes()
    got = input_specs(get_arch(VLM), shape_name, smoke=True)
    want = jax_input_specs(jax_get_arch(VLM), shape_name, smoke=True)
    part = "batch" if "batch" in want else "tokens"
    g = got[part] if part == "batch" else {"tokens": got["tokens"]}
    w = want[part] if part == "batch" else {"tokens": want["tokens"]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1], v.device.type)
            for k, v in g.items()} == \
        {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in w.items()}
    if cell.kind == "prefill":
        p = C.init_from_specs(cell.model.param_specs(),
                              torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.zeros(g["tokens"].shape, dtype=torch.int32),
                 "patch_embeds": torch.zeros(g["patch_embeds"].shape)}
        lg, cache = cell.step(p, batch)
        S = g["tokens"].shape[1] + cell.model.cfg.n_patches
        assert cache["len"] == S == cache["layers"][0]["k"].shape[1]


def test_vlm_serve_cli_matches_jax(capsys):
    """``python -m repro_torch.launch.serve --arch internvl2-26b --device
    cpu`` against the reference's CLI: the patch embeddings drawn as it
    draws them, the same prefix-cache accounting and output lines."""
    args = ["--arch", VLM, "--requests", "4", "--max-new", "2",
            "--n-prefixes", "2"]
    want = JSERVE.main(args)
    ref_lines = capsys.readouterr().out.splitlines()
    got = serve.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert got == want
    assert lines[1] == ref_lines[1]
    assert lines[0].split(" wall=")[0] == ref_lines[0].split(" wall=")[0]


def test_vlm_trainer_resumes_its_patch_draws():
    """``build_trainer("internvl2-26b")`` on the CPU: each batch carries
    patch embeddings drawn as the reference's trainer draws them (one
    stream from seed 7), and a step run again after later ones (a
    restart) gets the same batch and loss."""
    init_state, step_fn, m = train.build_trainer(VLM, smoke=True,
                                                 device="cpu")
    rng = np.random.default_rng(7)
    P, D = m.cfg.n_patches, m.cfg.lm.d_model
    first = step_fn.data.batch(0)["patch_embeds"]
    np.testing.assert_array_equal(
        first.numpy(), (rng.normal(size=(2, P, D)) * 0.25).astype(np.float32))
    state = init_state()
    losses = []
    for s in (0, 1, 2, 1):
        _, loss = step_fn(state, s)
        losses.append(loss)
    assert np.isfinite(losses).all() and losses[1] == losses[3]


def test_vlm_refuses_scan_layers():
    """``VLM`` passes ``scan_layers`` to its ``TransformerLM``, which
    refuses it."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_arch(VLM).model(smoke=True, scan_layers=True)
    assert dataclasses.asdict(get_arch(VLM).model(smoke=True).cfg) == \
        dataclasses.asdict(jax_get_arch(VLM).model(smoke=True).cfg)


def test_chip_smoke_teacher_forcing_on_moe_and_a_padded_vlm():
    """``chip_smoke``'s phase-12 helpers at smoke width on the CPU:
    ``teacher_forcing`` over internvl2 (8 patch embeddings, a vocabulary
    padded 509 -> 512 whose -1e30 rows must stay out of the norm) gives
    finite, nonzero distances within 1e-4; over the llama4-scout smoke
    model it records one routing a MoE layer a pass and reports no step
    routed otherwise; ``tf_faults`` catches a distance over the bound
    and a non-finite one, and passes a step routed otherwise."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, _, m, p, _ = _pair(VLM, seed=13)
    pe = {"patch_embeds": torch.from_numpy(np.random.default_rng(14).normal(
        size=(1, m.cfg.n_patches, m.cfg.lm.d_model)).astype(np.float32))}
    _, errs, flips = cs.teacher_forcing(m, p, _tokens(15, 12), 4, 32, "cpu",
                                        pe)
    assert flips == [False] * 3
    assert all(0 < rel < 1e-4 for rel, _ in errs)
    _, _, m, p, _ = _pair("llama4-scout-17b-a16e", seed=16)
    with cs.recorded_routes() as routed:
        _, errs, flips = cs.teacher_forcing(m, p, _tokens(17, 12), 3, 32,
                                            "cpu")
    # 5 passes (3 prefills, 2 decode steps) of 2 MoE layers, top-1
    assert flips == [False] * 2 and len(routed) == 10
    assert [r.shape for r in routed[:4]] == [(12, 1), (12, 1), (1, 1), (1, 1)]
    assert cs.tf_faults(errs, flips, 1e-4) == []
    assert cs.tf_faults([(0.2, 1.0), (float("nan"), 0.0), (0.9, 1.0)],
                        [False, False, True], 0.05) == [
        "step 0: relative L2 0.2 > 0.05", "step 1: relative L2 nan > 0.05"]
