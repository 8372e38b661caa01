"""Port parity, the SSM hybrid, RWKV6 and the encoder-decoder:
``repro_torch.models.{ssm, rwkv6, encdec}`` and the configs zamba2-2.7b,
rwkv6-7b and whisper-tiny, and their paths through ``ServeEngine``,
``build_cell``, ``build_trainer`` and ``launch/serve.py``, on the CPU
against the JAX package from the same numpy inputs at f32 (the JAX
references jitted, as their own entry points run them).

Tolerances: the chunked scans, logits and every cache leaf within
``max|port - ref| <= 1e-5 max|ref|`` (the same f32 arithmetic in another
summation order); the scans against the numpy per-token recurrences of
``tests/test_models.py`` within ``rtol = atol = 2e-4`` (that file's
bound: a chunked sum against a sequential one); the loss within 1e-6
relative; each gradient leaf within 5e-5 of its largest element (both
packages' gradients are up to ~2e-5 from an f64 evaluation of the same
gradient, on whisper's attention projections and norm gains: sums of
many cancelling terms); the trainer's losses within 1e-5; engine
outputs, stats and cell bytes equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import serve as JSERVE  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.encdec import _sinusoid as jax_sinusoid  # noqa: E402
from repro.models.rwkv6 import _chunk_wkv as jax_chunk_wkv  # noqa: E402
from repro.models.ssm import _ssd_chunk as jax_ssd_chunk  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.encdec import MAX_POSITIONS  # noqa: E402
from repro_torch.models.rwkv6 import _chunk_wkv  # noqa: E402
from repro_torch.models.ssm import _ssd_chunk  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

FAMILIES = ["zamba2-2.7b", "rwkv6-7b", "whisper-tiny"]
# prompt lengths: a multiple of the smoke chunk (16) or below it
PROMPT = {"zamba2-2.7b": 8, "rwkv6-7b": 16, "whisper-tiny": 4}


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


def _close(got, want, rel=1e-5, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), what


def _close_trees(got, want, rel=1e-5):
    g, w = _keyed(got), _keyed(want)
    assert sorted(g) == sorted(w)
    for key in w:
        _close(g[key], w[key], rel, key)


def _np_params(m, seed):
    """Numpy weights for ``m``'s specs: normal of std ``scale /
    sqrt(fan_in)`` (zero-initialised leaves too, so a wrong decay, bonus
    or lerp shows), the norms' gains 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.normal(size=spec.shape)).astype(np.float32)
        std = spec.scale / np.sqrt(max(1, spec.shape[0]))
        return (rng.normal(size=spec.shape) * std).astype(np.float32)
    return C.tree_map(one, m.param_specs())


def _extra(arch, m, B, seed):
    """whisper's frame embeddings [B, n_frames, D] as numpy, else {}."""
    if arch != "whisper-tiny":
        return {}
    rng = np.random.default_rng(seed)
    return {"frames": (rng.normal(size=(B, m.cfg.n_frames, m.cfg.d_model))
                       * 0.25).astype(np.float32)}


def _tokens(seed, shape, vocab=500):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def pairs():
    """Per family: the smoke model of both packages, numpy weights and
    both copies, built once; and one jitted JAX decode step a family."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        jm = jax_get_arch(arch).model(smoke=True)
        m = get_arch(arch).model(smoke=True)
        tree = _np_params(m, i)
        out[arch] = (jm, jax.tree.map(jnp.asarray, tree), m,
                     C.params_from_numpy(tree, "cpu"), tree)
        JAX_DECODE[arch] = jax.jit(jm.decode_step)
    return out


JAX_DECODE: dict = {}


# ---------------------------------------------------------------------------
# the chunked scans
# ---------------------------------------------------------------------------

def _ssd_case(S, seed=1):
    rng = np.random.default_rng(seed)
    B, H, dh, N = 2, 3, 4, 5
    return (rng.normal(size=(B, S, H, dh)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            -rng.uniform(0.01, 1.0, size=(B, S, H)).astype(np.float32),
            rng.normal(size=(B, H, dh, N)).astype(np.float32))


def _ssd_recurrence(xb, b, c, la, s0):
    """tests/test_models.py's per-token Mamba2 recurrence."""
    B, S, H, dh = xb.shape
    s, y = s0.copy(), np.zeros((B, S, H, dh), np.float32)
    for t in range(S):
        a = np.exp(la[:, t])
        for bi in range(B):
            for h in range(H):
                s[bi, h] = a[bi, h] * s[bi, h] + np.outer(xb[bi, t, h],
                                                          b[bi, t])
                y[bi, t, h] = s[bi, h] @ c[bi, t]
    return y, s


def _wkv_case(S, seed=0, decay=None, B=2, H=2, dh=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    if decay is None:
        lw = -rng.uniform(0.05, 1.5, size=(B, S, H, dh)).astype(np.float32)
        u = rng.normal(size=(H, dh)).astype(np.float32)
        s0 = rng.normal(size=(B, H, dh, dh)).astype(np.float32)
    else:
        lw = np.full((B, S, H, dh), decay, np.float32)
        u = np.zeros((H, dh), np.float32)
        s0 = np.zeros((B, H, dh, dh), np.float32)
    return r, k, v, lw, u, s0


def _wkv_recurrence(r, k, v, lw, u, s0):
    """tests/test_models.py's per-token RWKV6 recurrence."""
    B, S, H, dh = r.shape
    s, y = s0.copy(), np.zeros((B, S, H, dh), np.float32)
    for t in range(S):
        w = np.exp(lw[:, t])
        for bi in range(B):
            for h in range(H):
                bonus = np.outer(u[h] * k[bi, t, h], v[bi, t, h])
                y[bi, t, h] = r[bi, t, h] @ (s[bi, h] + bonus)
                s[bi, h] = np.diag(w[bi, h]) @ s[bi, h] + np.outer(
                    k[bi, t, h], v[bi, t, h])
    return y, s


@pytest.mark.parametrize("S", [24, 5])
def test_ssd_chunk_matches_jax_and_the_recurrence(S):
    """``_ssd_chunk`` at chunk 8 (S a multiple of it, and S below it: one
    short chunk) from a non-zero state: y and the state against the
    reference's function and the per-token recurrence."""
    case = _ssd_case(S)
    jy, js = jax.jit(jax_ssd_chunk, static_argnums=5)(
        *map(jnp.asarray, case), 8)
    y, s = _ssd_chunk(*map(torch.from_numpy, case), chunk=8)
    _close(y, jy)
    _close(s, js)
    ry, rs = _ssd_recurrence(*case)
    np.testing.assert_allclose(_np(y), ry, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s), rs, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [32, 5])
def test_chunk_wkv_matches_jax_and_the_recurrence(S):
    """``_chunk_wkv`` at chunk 8 (S a multiple of it, and S below it) from
    a non-zero state with a bonus: y and the state against the
    reference's function and the per-token recurrence."""
    case = _wkv_case(S)
    jy, js = jax.jit(jax_chunk_wkv, static_argnums=6)(
        *map(jnp.asarray, case), 8)
    y, s = _chunk_wkv(*map(torch.from_numpy, case), chunk=8)
    _close(y, jy)
    _close(s, js)
    ry, rs = _wkv_recurrence(*case)
    np.testing.assert_allclose(_np(y), ry, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s), rs, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("decay", [-1.0, -1.5, -2.0])
def test_chunk_wkv_does_not_overflow(decay):
    """A constant log-decay over one 64-token chunk (B=1, H=2, dh=8, r/k/v
    ~ N(0,1) from seed 0, u = 0, a zero state). The reference scales r by
    e^{clw_prev - clw_L}, up to e^{63 |decay|}: inf past 88.7, and inf x 0
    gives NaN at -1.5 and -2.0. The port forms each score from the
    exponent difference (<= 0) and stays finite, equal to its own chunk-1
    run and to the recurrence; at -1.0 it equals the reference."""
    case = _wkv_case(64, decay=decay, B=1)
    jy, _ = jax.jit(jax_chunk_wkv, static_argnums=6)(
        *map(jnp.asarray, case), 64)
    y, s = _chunk_wkv(*map(torch.from_numpy, case), chunk=64)
    y1, s1 = _chunk_wkv(*map(torch.from_numpy, case), chunk=1)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, y1)
    _close(s, s1)
    ry, rs = _wkv_recurrence(*case)
    np.testing.assert_allclose(_np(y), ry, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s), rs, rtol=2e-4, atol=2e-4)
    if decay == -1.0:
        _close(y, jy)
    else:
        assert np.isnan(np.asarray(jy)).any()


def test_chunk_wkv_gradient_is_finite_at_strong_decay():
    """The gradient of ``sum(y) + sum(state)`` through a 16-token chunk
    whose log-decays sum to -480 (the reference's r scale would be
    e^450): finite, and equal to the gradient through the chunk-1 form
    within 1e-4 relative and 1e-5 absolute (the gradients are O(1); the
    log-decays' are ~e^-30 in exact arithmetic and rounding noise of the
    O(1) terms in either form)."""
    r, k, v, _, u, s0 = _wkv_case(16)
    lw = np.full(r.shape, -30.0, np.float32)
    grads = []
    for chunk in (16, 1):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (r, k, v, lw, u, s0)]
        y, s = _chunk_wkv(*ins, chunk=chunk)
        grads.append(torch.autograd.grad(y.sum() + s.sum(), ins))
    for g, g1 in zip(*grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), _np(g1), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the three models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch, pairs):
    """Prefill logits and the whole cache tree (Zamba2: conv tails, SSM
    states, the attention ring; RWKV6: both token shifts and the WKV
    state; whisper: self-attention K/V and ``memory``), then 4 decode
    steps, logits and cache, from carried weights."""
    jm, jp, m, p, _ = pairs[arch]
    S = PROMPT[arch]
    b = {"tokens": _tokens(0, (2, S)), **_extra(arch, m, 2, 1)}
    jl, jc = jax.jit(lambda p_, b_: jm.prefill(p_, b_, 24))(jp, _jax(b))
    lg, c = m.prefill(p, _torch(b), 24)
    _close(lg, jl)
    _close_trees({k: v for k, v in c.items() if k != "len"},
                 {k: v for k, v in jc.items() if k != "len"})
    jax_decode = JAX_DECODE[arch]
    for s in _tokens(1, (4, 2, 1)):
        jl, jc = jax_decode(jp, jc, jnp.asarray(s))
        lg, c = m.decode_step(p, c, torch.from_numpy(s))
        _close(lg, jl)
        _close_trees({k: v for k, v in c.items() if k != "len"},
                     {k: v for k, v in jc.items() if k != "len"})
    assert c["len"] == int(jc["len"]) == S + 4


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax(arch, pairs):
    """``loss`` and every gradient leaf (port autograd against
    ``jax.grad``) at batch 2, seq 16, from carried weights."""
    jm, jp, m, p, tree = pairs[arch]
    toks = _tokens(3, (2, 17))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         **_extra(arch, m, 2, 4)}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, _jax(b))
    loss, grads = steps.loss_and_grads(m, p, _torch(b))
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    want = _keyed(jax.tree.map(np.asarray, jg))
    for key, g in zip(_keyed(tree), C.tree_leaves(grads)):
        _close(g, want[key], rel=5e-5, what=key)


@pytest.mark.parametrize("case", ["tail", "crossing"])
def test_zamba2_ring_matches_jax(case, pairs):
    """The shared block's ring at max_len 12 (A = 12 slots, below the
    smoke window of 16): ``tail``, a 16-token prefill keeps the last 12
    tokens and 4 decode steps roll the ring; ``crossing``, an 8-token
    prefill writes at slot 0 and 6 decode steps cross len = A. Logits and
    every cache leaf against the reference each step."""
    jm, jp, m, p, _ = pairs["zamba2-2.7b"]
    S, n = (16, 4) if case == "tail" else (8, 6)
    toks = _tokens(5, (2, S))
    jl, jc = jax.jit(lambda p_, t: jm.prefill(p_, {"tokens": t}, 12))(
        jp, jnp.asarray(toks))
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)}, 12)
    assert c["layers"]["attn"][0]["k"].shape[1] == 12
    _close(lg, jl)
    _close_trees(c["layers"], jc["layers"])
    jax_decode = JAX_DECODE["zamba2-2.7b"]
    for s in _tokens(6, (n, 2, 1)):
        jl, jc = jax_decode(jp, jc, jnp.asarray(s))
        lg, c = m.decode_step(p, c, torch.from_numpy(s))
        _close(lg, jl)
        _close_trees(c["layers"], jc["layers"])


def test_whisper_position_table_matches_jax():
    """The decoder's position table, built once per model and device:
    rows 0, 4,095, 4,096 and 65,535 against the reference's
    ``_sinusoid(16 * 4096, D)`` as XLA computes it under ``jit`` (where
    the model runs), at the smoke and the full width; the same tensor on
    a second call."""
    for smoke, D in ((True, 64), (False, 384)):
        m = get_arch("whisper-tiny").model(smoke=smoke)
        want = np.asarray(jax.jit(jax_sinusoid, static_argnums=(0, 1))(
            MAX_POSITIONS, D))
        got = m.position_table("cpu")
        assert got.shape == (MAX_POSITIONS, D)
        assert m.position_table("cpu") is got
        for row in (0, 4095, 4096, 65535):
            _close(got[row], want[row], what=f"D {D} row {row}")


def test_refused_chunk_lengths_match_the_reference(pairs):
    """A prefill whose length is over the chunk and not a multiple of it
    is refused by both packages' chunk assert (the SSD and the WKV)."""
    for arch in ("zamba2-2.7b", "rwkv6-7b"):
        jm, jp, m, p, _ = pairs[arch]
        toks = _tokens(7, (1, 24))
        with pytest.raises(AssertionError):
            m.prefill(p, {"tokens": torch.from_numpy(toks)}, 32)
        with pytest.raises(AssertionError):
            jax.jit(lambda p_, t: jm.prefill(p_, {"tokens": t}, 32))(
                jp, jnp.asarray(toks))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_matches_jax(arch, pairs):
    """The smoke model through the JAX engine and
    ``ServeEngine(device="cpu")``: a stream with a repeated prompt (a
    prefix-cache hit carries the whole cache tree), equal greedy outputs
    and ``stats()``."""
    jm, jp, m, p, _ = pairs[arch]
    extra = _extra(arch, m, 1, 8)
    jeng = JE.ServeEngine(jm, jp, max_len=32)
    eng = engine.ServeEngine(m, p, max_len=32, device="cpu")
    prompts = _tokens(9, (2, PROMPT[arch]))
    got = [engine.Request(rid=i, prompt=prompts[j].copy(), max_new=n)
           for i, (j, n) in enumerate([(0, 4), (1, 3), (0, 4)])]
    want = [JE.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in got]
    eng.run(got, extra_inputs=_torch(extra))
    jeng.run(want, extra_inputs=_jax(extra))
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.stats() == jeng.stats()
    assert got[0].output == got[2].output


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_matches_jax_from_a_carried_state(arch):
    """Two ``build_trainer(arch)`` steps (pipeline, whisper's frames drawn
    as the reference draws them, loss and gradient, AdamW) against the JAX
    trainer's from one state carried into both."""
    _, jstep, _ = JT.build_trainer(arch, smoke=True)
    _, step_fn, m = train.build_trainer(arch, smoke=True, device="cpu")
    np_p = _np_params(m, 10)
    zeros = {"m": C.tree_map(np.zeros_like, np_p),
             "v": C.tree_map(np.zeros_like, np_p), "step": np.int32(0)}
    js = jax.tree.map(jnp.asarray, {"params": np_p, "opt": zeros,
                                    "step_count": np.zeros((), np.int64)})
    state = {"params": C.params_from_numpy(np_p, "cpu"),
             "opt": C.params_from_numpy(zeros, "cpu"),
             "step_count": np.zeros((), np.int64)}
    for s in range(2):
        js, want = jstep(js, s)
        state, got = step_fn(state, s)
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_build_cell_builds_every_arch(shape_name):
    """``build_cell`` on the CPU for each of the ten archs at each shape
    it applies to: the constructor's keywords filtered by its signature
    (``EncDecLM`` takes no ``remat``, ``RWKV6LM`` no ``q_chunk``), and
    ``Cell.arg_local_bytes`` equal to the reference's at smoke width."""
    from repro.configs import REGISTRY as JREG
    from repro_torch.configs import ARCH_IDS, applicable_shapes
    assert ARCH_IDS == sorted(JREG)
    mesh = make_host_mesh()
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        if shape_name not in applicable_shapes(arch):
            continue
        cell = steps.build_cell(arch, shape_name, device="cpu", smoke=True)
        jcell = JSTEPS.build_cell(jax_get_arch(arch_id), shape_name, mesh,
                                  smoke=True)
        assert cell.arg_local_bytes() == jcell.arg_local_bytes(), arch_id


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_matches_jax(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``:
    whisper against the reference's CLI (its frames drawn as the reference
    draws them), the same prefix-cache accounting and output lines; the
    other two against the accounting of 4 requests over 2 prompts (the
    engine's outputs and stats are held to JAX's above)."""
    args = ["--arch", arch, "--requests", "4", "--max-new", "2",
            "--n-prefixes", "2"]
    if arch != "whisper-tiny":
        got = serve.main(args + ["--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert got["prefill_tokens_saved_frac"] == 0.5
        assert got["wasted_probes"] <= got["lookups"]
        assert lines[0].startswith(f"[serve] arch={arch} requests=4 tokens=8")
        return
    want = JSERVE.main(args)
    ref_lines = capsys.readouterr().out.splitlines()
    got = serve.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert got == want
    assert lines[1] == ref_lines[1]
    assert lines[0].split(" wall=")[0] == ref_lines[0].split(" wall=")[0]


LEAF_KINDS = {"zamba2-2.7b": {"conv", "s", "k", "v"},
              "rwkv6-7b": {"xt", "xc", "s"},
              "whisper-tiny": {"k", "v", "memory"}}


def test_chip_smoke_serve_and_teacher_forcing_on_the_new_families(pairs):
    """``chip_smoke``'s phase-13 helpers at smoke width on the CPU:
    ``serve_cell`` with whisper's frames through ``extra`` (no fault, the
    stats of a second run), ``teacher_forcing`` over each family within
    ``TF_REL_F32`` (a prompt of 8: every teacher prefill fits one smoke
    chunk), ``lost_state_rels`` (every kind of cache leaf zeroed reads
    above that bound), ``draw_state_leaves`` (the same values into numpy
    and torch trees, only the zero- and one-initialised leaves redrawn)
    and ``loss_grad_parts`` with the frames."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in FAMILIES:
        _, _, m, p, tree = pairs[arch]
        extra = _torch(_extra(arch, m, 1, 11))
        kw = dict(n_requests=4, n_prompts=2, prompt_len=PROMPT[arch],
                  max_new=3, max_len=32, extra=extra)
        a = cs.serve_cell(m, p, "cpu", **kw)
        assert cs.serve_faults(a, cs.serve_cell(m, p, "cpu", **kw)) == []
        _, errs, flips = cs.teacher_forcing(m, p, _tokens(12, 8), 4, 32,
                                            "cpu", extra)
        assert cs.tf_faults(errs, flips, cs.TF_REL_F32) == []
        lost = cs.lost_state_rels(m, p, _tokens(12, 8), 3, 32, "cpu", extra)
        assert set(lost) == LEAF_KINDS[arch] | {"all"}
        assert min(lost.values()) > cs.TF_REL_F32 and lost["all"] > 0.5
        specs = m.param_specs()
        drawn = cs.draw_state_leaves(specs, C.tree_map(np.copy, tree), 3)
        on_torch = cs.draw_state_leaves(
            specs, C.params_from_numpy(tree, "cpu"), 3)
        for sp, a, b, t in zip(C.tree_leaves(specs), C.tree_leaves(drawn),
                               C.tree_leaves(on_torch), C.tree_leaves(tree)):
            np.testing.assert_array_equal(b.numpy(), a)
            assert (sp.init in ("zeros", "ones")) != np.array_equal(a, t)
        loss, grads = cs.loss_grad_parts(m, tree, _tokens(13, (1, 9)), "cpu",
                                         extra)
        assert np.isfinite(loss) and len(grads) == len(C.tree_leaves(tree))
