"""Port parity, the LM serving path: ``repro_torch.models`` (the dense
transformer), ``repro_torch.configs``, ``repro_torch.serving.engine`` and
``repro_torch.launch.serve`` on the CPU against the JAX package, weights
carried across by ``params_from_numpy``. Compute in f32 on both sides.
Tolerances: logits and KV caches within 1e-5 (absolute and relative: the
same f32 arithmetic in another summation order); decode against teacher
forcing in the port within 1e-4; head padding, greedy outputs and
prefix-cache stats equal."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import applicable_shapes as japp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import (SHAPES, applicable_shapes,  # noqa: E402
                                 get_arch)
from repro_torch.configs.llama3_2_1b import FULL, SMOKE  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.transformer import (TransformerConfig,  # noqa: E402
                                            TransformerLM)
from repro_torch.serving import engine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_f32_compute():
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    yield
    C.set_compute_dtype(was)


# the smoke llama, and a one-layer model with what llama3.2-1b leaves off:
# q/k norms, a sliding window shorter than the prompt, a padded vocab
VARIANT = dict(name="variant", n_layers=1, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=96, vocab=500, head_dim=16, qk_norm=True,
               sliding_window=5, vocab_pad_to=64)


def _carried(seed=0, variant=False):
    """A model of both packages, the JAX weights and the port's copy of
    them: the smoke llama from the reference's ``init_from_specs``, or
    VARIANT from numpy draws (q/k norm gains away from 1)."""
    if not variant:
        jm = jax_get_arch("llama3.2-1b").model(smoke=True)
        jp = JC.init_from_specs(jm.param_specs(), jax.random.key(seed))
        m = get_arch("llama3.2-1b").model(smoke=True)
        return jm, jp, m, C.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")
    jm, m = JaxLM(JaxConfig(**VARIANT)), TransformerLM(TransformerConfig(**VARIANT))
    rng = np.random.default_rng(seed)
    tree = C.tree_map(lambda spec: (rng.normal(size=spec.shape) * 0.2 + (
        spec.init == "ones")).astype(np.float32), m.param_specs())
    return jm, jax.tree.map(jnp.asarray, tree), m, C.params_from_numpy(
        tree, "cpu")


@pytest.fixture(scope="module")
def smoke_llama():
    """``_carried()`` once for the tests that only read it."""
    return _carried()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("variant", [False, True],
                         ids=["llama3.2-1b-smoke", "qk_norm-window-padded"])
def test_prefill_and_decode_match_jax(variant, smoke_llama):
    """Prefill logits and every layer's KV cache, then 4 decode steps."""
    jm, jp, m, p = _carried(variant=True) if variant else smoke_llama
    toks = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(lambda p_, b: jm.prefill(p_, b, 20))(
        jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)}, 20)
    np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    for jl_, l_ in zip(jc["layers"], c["layers"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(l_[k]), _np(jl_[k]), **TOL)
    assert c["len"] == int(jc["len"]) == 12
    steps = np.random.default_rng(1).integers(0, 512, (4, 2, 1))
    jax_decode = jax.jit(jm.decode_step)
    for s in steps.astype(np.int32):
        jl, jc = jax_decode(jp, jc, jnp.asarray(s))
        lg, c = m.decode_step(p, c, torch.from_numpy(s))
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    assert c["len"] == int(jc["len"]) == 16


def test_decode_matches_teacher_forcing():
    """Prefill(t[:k]) + decode(t[k:]) reproduces the full prefill's last
    logits (the mirror of tests/test_models.py's, in the port), and a
    decode step leaves the cache it was given as it was."""
    _, _, m, p = _carried(3)
    toks = np.random.default_rng(3).integers(0, 32, (2, 12)).astype(np.int32)
    full, _ = m.prefill(p, {"tokens": torch.from_numpy(toks)}, 16)
    _, cache = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :8])}, 16)
    before = [layer["k"].clone() for layer in cache["layers"]]
    first = cache
    for i in range(8, 12):
        last, cache = m.decode_step(p, cache, torch.from_numpy(toks[:, i:i + 1]))
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -1]),
                               rtol=1e-4, atol=1e-4)
    assert all(torch.equal(b, layer["k"])
               for b, layer in zip(before, first["layers"]))


def test_head_padding_bitwise_exact():
    """Zero-padded q/o heads leave the logits bit for bit as they were
    (the mirror of tests/test_models.py's, on prefill logits in place of
    the loss)."""
    cfg = TransformerConfig(name="t", n_layers=1, d_model=32, n_heads=5,
                            n_kv_heads=1, d_ff=64, vocab=64, head_dim=8)
    m1, m2 = TransformerLM(cfg, tp_divisor=1), TransformerLM(cfg, tp_divisor=8)
    assert m2.H == 8
    g = torch.Generator().manual_seed(0)
    p1 = C.init_from_specs(m1.param_specs(), g, "cpu")
    p2 = C.init_from_specs(m2.param_specs(), g, "cpu")
    for l1, l2 in zip(p1["layers"], p2["layers"]):
        a1, a2 = l1["attn"], l2["attn"]
        a2["wq"] = torch.zeros_like(a2["wq"])
        a2["wq"][:, :5] = a1["wq"]
        a2["wo"] = torch.zeros_like(a2["wo"])
        a2["wo"][:5] = a1["wo"]
        a2["wk"], a2["wv"] = a1["wk"], a1["wv"]
        l2["ln1"], l2["ln2"], l2["mlp"] = l1["ln1"], l1["ln2"], l1["mlp"]
    for k in ("embed", "lm_head", "ln_f"):
        p2[k] = p1[k]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    lg1, _ = m1.prefill(p1, {"tokens": toks}, 16)
    lg2, _ = m2.prefill(p2, {"tokens": toks}, 16)
    assert torch.equal(lg2, lg1)


@pytest.mark.parametrize("what", ["whisper-tiny", "rwkv6-7b", "zamba2-2.7b",
                                  "scan"])
def test_unported_configs_are_refused(what):
    """What the port does not have: the enc-dec, RWKV6 and SSM-hybrid
    archs (``get_arch`` does not know them; the reference's registry
    does) and scanned layers."""
    if what == "scan":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TransformerLM(SMOKE, scan_layers=True)
        return
    assert jax_get_arch(what).arch_id == what
    with pytest.raises(KeyError):
        get_arch(what)


def test_configs_match_the_reference():
    """FULL and SMOKE equal the reference's configs (field by field), the
    full model's parameter count is 1,498,480,640, and the shape table and
    its policy are the reference's."""
    from repro.configs import SHAPES as JSHAPES
    from repro.configs.llama3_2_1b import FULL as JFULL, SMOKE as JSMOKE
    for port_cfg, ref_cfg in ((FULL, JFULL), (SMOKE, JSMOKE)):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    assert FULL.param_count() == JFULL.param_count() == 1_498_480_640
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    arch = get_arch("llama3.2-1b")
    assert applicable_shapes(arch) == japp(jax_get_arch("llama3.2-1b")) == [
        "train_4k", "prefill_32k", "decode_32k"]
    m = arch.model(smoke=True)
    g = torch.Generator().manual_seed(0)
    p = C.init_from_specs(m.param_specs(), g, "cpu")
    # the reference's count leaves out the final norm's d_model gains
    n = sum(a.numel() for a in C.tree_leaves(p))
    assert n == m.param_count() + SMOKE.d_model


PORTED = {"deepseek-7b": ("dense", 6_910_361_600),
          "deepseek-67b": ("dense", 67_424_993_280),
          "qwen3-14b": ("dense", 14_768_291_840),
          "deepseek-v2-lite-16b": ("moe", 15_706_482_176),
          "llama4-scout-17b-a16e": ("moe", 107_769_856_000),
          "internvl2-26b": ("vlm", 19_861_254_144)}


@pytest.mark.parametrize("arch_id", sorted(PORTED))
def test_ported_configs_match_the_reference(arch_id):
    """FULL and SMOKE of each arch ported with MoE, MLA and the VLM equal
    the reference's field by field; ``param_count``,
    ``active_param_count``, the family and ``applicable_shapes`` equal;
    the reference's smoke weights carry across by ``params_from_numpy``
    with the port's keys, shapes and dtypes, as many values as
    ``param_count`` says and those it leaves out."""
    import importlib
    mod = arch_id.replace("-", "_").replace(".", "_")
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    ref = importlib.import_module(f"repro.configs.{mod}")
    for port_cfg, ref_cfg in ((port.FULL, ref.FULL), (port.SMOKE, ref.SMOKE)):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.param_count() == ref_cfg.param_count()
        assert port_cfg.active_param_count() == ref_cfg.active_param_count()
    arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
    family, n_full = PORTED[arch_id]
    assert arch.family == jarch.family == family
    assert port.FULL.param_count() == n_full
    if arch_id == "deepseek-v2-lite-16b":
        assert port.FULL.active_param_count() == 2_661_148_160
    assert applicable_shapes(arch) == japp(jarch)
    jm, m = jarch.model(smoke=True), arch.model(smoke=True)
    jp = JC.init_from_specs(jm.param_specs(), jax.random.key(0))
    p = C.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def by_path(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in by_path(sub, f"{prefix}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in by_path(sub, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}
    assert by_path(p) == by_path(m.param_specs())
    n = sum(a.numel() for a in C.tree_leaves(p))
    c = getattr(m.cfg, "lm", m.cfg)
    # the reference's count leaves out the final norm's gains, the q/k
    # norms' gains and the vocabulary's padding rows
    uncounted = (c.d_model + 2 * c.n_layers * c.dh * c.qk_norm
                 + 2 * (c.padded_vocab - c.vocab) * c.d_model)
    assert n == m.param_count() + uncounted


def test_serve_engine_matches_jax(smoke_llama):
    """One request stream with a repeated prompt (within a run and across
    runs) through the JAX engine and ``ServeEngine(device="cpu")``: equal
    outputs and equal ``stats()``; a hit served after a longer decode of
    the same prompt gives the first request's tokens (the stored payload
    is a copy)."""
    jm, jp, m, p = smoke_llama
    jeng = JE.ServeEngine(jm, jp, max_len=40)
    eng = engine.ServeEngine(m, p, max_len=40, device="cpu")
    prompts = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    stream = [[(0, 4), (1, 4), (0, 4)], [(0, 12), (1, 3)], [(0, 4)]]
    outs = []
    for batch in stream:
        got = [engine.Request(rid=i, prompt=prompts[j].copy(), max_new=n)
               for i, (j, n) in enumerate(batch)]
        want = [JE.Request(rid=i, prompt=prompts[j].copy(), max_new=n)
                for i, (j, n) in enumerate(batch)]
        eng.run(got)
        jeng.run(want)
        assert [r.output for r in got] == [r.output for r in want]
        assert eng.stats() == jeng.stats()
        outs.append([r.output for r in got])
    assert outs[0][0] == outs[0][2] == outs[2][0] == outs[1][0][:4]
    assert eng.stats()["prefill_tokens_saved_frac"] == 4 / 6
    stored, _ = eng.prefix_cache.lookup(engine._prefix_key(prompts[0]))
    fresh = m.prefill(p, {"tokens": torch.from_numpy(prompts[:1])}, 40)
    assert stored[1]["len"] == fresh[1]["len"] == 8
    assert all(torch.equal(a[k], b[k]) for a, b in
               zip(stored[1]["layers"], fresh[1]["layers"]) for k in "kv")


def test_serve_cli_matches_jax(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` against the
    reference's ``launch/serve.py``: the same prefix-cache accounting and the same
    output lines."""
    args = ["--requests", "6", "--max-new", "2", "--n-prefixes", "2"]
    want = JS.main(args)
    ref_lines = capsys.readouterr().out.splitlines()
    got = serve.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert got == want
    assert got["prefill_tokens_saved_frac"] == 4 / 6
    assert lines[1] == ref_lines[1]
    assert lines[0].split(" wall=")[0] == ref_lines[0].split(" wall=")[0]
    assert C.COMPUTE_DTYPE == torch.float32


def test_chip_smoke_serve_cell_on_the_cpu():
    """``chip_smoke``'s phase-10 helpers at smoke width on the CPU: the
    serve cell (16 requests over 4 prompts, twice, then a fresh engine)
    with no fault and the stats of a twin engine; the engine's first
    prompt decoded as teacher forcing says; ``forced_logits`` over the
    same numpy weights on two models equal."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = get_arch(cs.LM_ARCH).model(smoke=True)
    g = torch.Generator().manual_seed(0)
    p = C.init_from_specs(m.param_specs(), g, "cpu")
    kw = dict(prompt_len=16, max_new=4, max_len=32)
    cell = cs.serve_cell(m, p, "cpu", **kw)
    twin_m = TransformerLM(dataclasses.replace(SMOKE, d_model=32, d_ff=64))
    twin_p = C.init_from_specs(twin_m.param_specs(), g, "cpu")
    twin = cs.serve_cell(twin_m, twin_p, "cpu", **kw)
    assert cs.serve_faults(cell, twin) == []
    assert cell["runs"][1]["stats"]["prefill_tokens_saved_frac"] == 0.875
    assert len(cell["runs"][0]["outputs"]) == cs.LM_REQUESTS
    gen, errs, flips = cs.teacher_forcing(m, p, cell["prompts"][0], 4, 32,
                                          "cpu")
    assert gen == cell["runs"][0]["outputs"][0]
    assert len(errs) == 3 and max(rel for rel, _ in errs) < 1e-5
    assert flips == [False] * 3
    np_p = cs.numpy_params(m.param_specs(), seed=1)
    a = cs.forced_logits(m, C.params_from_numpy(np_p, "cpu"),
                         cell["prompts"][0], [1, 2], 32, "cpu")
    b = cs.forced_logits(m, C.params_from_numpy(np_p, "cpu"),
                         cell["prompts"][0], [1, 2], 32, "cpu")
    assert len(a) == 3 and all(np.array_equal(x, y) for x, y in zip(a, b))
    # a broken cell is caught
    cell["runs"][1]["outputs"][0] = [0]
    assert "the second run (prefix-cache hits) != the first" in \
        cs.serve_faults(cell)
