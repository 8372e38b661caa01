"""Port parity, the training path's substrate: ``optim`` (AdamW, clipping,
schedules, bf16 and int8 error-feedback compression), ``data`` (the
synthetic pipeline and its Bloom-staged dedup), ``checkpoint`` (the same
manifest and chunk bytes as the JAX store, a checkpoint crossing both
ways) and ``ft`` (the supervisor's restart, the straggler monitor), on
the CPU against the JAX package. Tolerances: f32 optimizer arithmetic
within 1e-5 relative (another order of the same operations); int8 codes
and scales, batches, dedup decisions and counts, manifests, chunk bytes
and straggler flags equal."""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.data.dedup import StreamingDedup as JaxDedup  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JaxData  # noqa: E402
from repro.ft.straggler import StragglerMonitor as JaxMonitor  # noqa: E402
from repro.ft.supervisor import FailureInjector as JaxInjector  # noqa: E402
from repro.ft.supervisor import Supervisor as JaxSupervisor  # noqa: E402
from repro.optim import adamw as JA, compress as JCo, schedule as JSc  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore, latest_step,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import DataConfig, StreamingDedup, SyntheticLMData  # noqa: E402
from repro_torch.ft import (FailureInjector, StragglerMonitor,  # noqa: E402
                            Supervisor)
from repro_torch.ft.supervisor import InjectedFailure  # noqa: E402
from repro_torch.launch.train import ResumableData  # noqa: E402
from repro_torch.optim import (AdamWConfig, CompressionConfig,  # noqa: E402
                               adamw_init, adamw_step, compress_grads,
                               cosine_schedule, decompress_grads, global_norm,
                               linear_warmup_cosine)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ optim
def test_adamw_matches_jax_on_a_quadratic():
    """300 AdamW steps on sum((w - t)^2) in both packages: the same path
    over the first 100 steps (params and grad_norm each step), and both
    converged. Near the optimum g is small and m / sqrt(v) amplifies the
    last bits of two compilers' arithmetic, so the paths are held while
    the gradient is large."""
    cfg = dict(lr=0.1, weight_decay=0.01)
    tgt = np.asarray([1.0, 2.0, -1.0], np.float32)
    jp, p = {"w": jnp.asarray([5.0, -3.0, 2.0])}, {"w": torch.tensor([5.0, -3.0, 2.0])}
    jo, o = JA.adamw_init(jp), adamw_init(p)
    assert o["step"].dtype == torch.int32 and o["m"]["w"].dtype == torch.float32

    @jax.jit
    def jstep(jp, jo):
        g = jax.grad(lambda q: jnp.sum((q["w"] - tgt) ** 2))(jp)
        return JA.adamw_step(JA.AdamWConfig(**cfg), jp, g, jo)

    for i in range(300):
        jp, jo, jm = jstep(jp, jo)
        g = {"w": 2 * (p["w"] - torch.from_numpy(tgt))}
        p, o, m = adamw_step(AdamWConfig(**cfg), p, g, o)
        if i < 100:
            np.testing.assert_allclose(_np(p["w"]), _np(jp["w"]), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(_np(p["w"]), tgt, atol=1e-2)
    np.testing.assert_allclose(_np(jp["w"]), tgt, atol=1e-2)
    assert int(o["step"]) == int(jo["step"]) == 300


def test_grad_clip_and_global_norm_match_jax():
    """A gradient of norm 2e6 is clipped to 1 in both; ``global_norm`` of
    a mixed-dtype tree."""
    jp, p = {"w": jnp.zeros(4)}, {"w": torch.zeros(4)}
    huge = np.full(4, 1e6, np.float32)
    jp2, _, jm = JA.adamw_step(JA.AdamWConfig(lr=1e-3), jp,
                               {"w": jnp.asarray(huge)}, JA.adamw_init(jp))
    p2, _, m = adamw_step(AdamWConfig(lr=1e-3), p, {"w": torch.from_numpy(huge)},
                          adamw_init(p))
    assert float(m["grad_norm"]) == float(jm["grad_norm"]) == 2e6
    np.testing.assert_allclose(_np(p2["w"]), _np(jp2["w"]), rtol=1e-6)
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0], dtype=torch.bfloat16)}
    assert float(global_norm(t)) == float(JA.global_norm(
        {"a": jnp.asarray([3.0]), "b": jnp.asarray([4.0], jnp.bfloat16)})) == 5.0


@pytest.mark.parametrize("step", [0, 5, 10, 37, 100, 150])
def test_schedules_match_jax(step):
    js, s = jnp.int32(step), torch.tensor(step, dtype=torch.int32)
    np.testing.assert_allclose(float(linear_warmup_cosine(s, 10, 100)),
                               float(JSc.linear_warmup_cosine(js, 10, 100)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(cosine_schedule(s, 100)),
                               float(JSc.cosine_schedule(js, 100)),
                               rtol=1e-6, atol=1e-7)


def test_bf16_compression_matches_jax():
    g = {"a": np.asarray([1.0, 2.0, 3.1], np.float32),
         "b": np.asarray([[0.5e-3]], np.float32)}
    cfg, jcfg = CompressionConfig("bf16"), JCo.CompressionConfig("bf16")
    wire, aux = compress_grads(cfg, {k: torch.from_numpy(v) for k, v in g.items()})
    jwire, jaux = JCo.compress_grads(jcfg, jax.tree.map(jnp.asarray, g))
    assert aux is jaux is None
    for k in g:
        assert wire[k].dtype == torch.bfloat16
        back = decompress_grads(cfg, wire, aux)[k]
        np.testing.assert_array_equal(_np(back), np.asarray(
            JCo.decompress_grads(jcfg, jwire, jaux)[k]))
    assert compress_grads(CompressionConfig(), g) == (g, None)
    with pytest.raises(ValueError):
        compress_grads(CompressionConfig("fp4"), g)


def test_int8_error_feedback_matches_jax():
    """Five steps of int8 quantization with the residual carried: the int8
    codes and the scales bit-equal to JAX's, the residuals and the
    dequantized gradients equal within f32 rounding."""
    cfg, jcfg = CompressionConfig("int8_ef"), JCo.CompressionConfig("int8_ef")
    rng = np.random.default_rng(0)
    err = jerr = None
    jq = functools.partial(JCo.compress_grads, jcfg)
    for _ in range(5):
        g = {"w": (rng.normal(size=(8, 5)) * 0.1).astype(np.float32),
             "b": (rng.normal(size=7) * 1e-3).astype(np.float32)}
        wire, aux = compress_grads(cfg, {k: torch.from_numpy(v) for k, v in g.items()},
                                   err)
        jwire, jaux = jq(jax.tree.map(jnp.asarray, g), jerr)
        for k in g:
            assert wire[k].dtype == torch.int8
            np.testing.assert_array_equal(_np(wire[k]), np.asarray(jwire[k]))
            np.testing.assert_array_equal(_np(aux["scales"][k]),
                                          np.asarray(jaux["scales"][k]))
            np.testing.assert_allclose(_np(aux["residual"][k]),
                                       np.asarray(jaux["residual"][k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_array_equal(
                _np(decompress_grads(cfg, wire, aux)[k]),
                np.asarray(JCo.decompress_grads(jcfg, jwire, jaux)[k]))
        err, jerr = aux["residual"], jaux["residual"]


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(), dict(dedup=False),
                                dict(n_hosts=2, host_id=1)],
                         ids=["dedup", "no-dedup", "host-shard"])
def test_pipeline_matches_jax(kw):
    """Batches of steps 0, 3 and 11, then step 3 again (its documents now
    dropped as duplicates where dedup is on): equal tokens, labels and
    ``n_dropped`` (Python's ``hash`` is salted per process, so the two
    packages agree within one)."""
    cfg = dict(vocab=1024, seq_len=64, global_batch=4, seed=7, **kw)
    a, b = SyntheticLMData(DataConfig(**cfg)), JaxData(JaxDataConfig(**cfg))
    for step in (0, 3, 11, 3):
        x, y = a.batch(step), b.batch(step)
        for k in ("tokens", "labels"):
            assert x[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
        assert a.n_dropped == b.n_dropped
    assert (a.n_dropped > 0) == kw.get("dedup", True)


def test_streaming_dedup_matches_jax():
    """Query-and-insert over hashes with repeats inside and across
    batches: equal decisions, probe counts, efficiency and Bloom words."""
    a, b = StreamingDedup(capacity=4096, seed=3), JaxDedup(capacity=4096, seed=3)
    rng = np.random.default_rng(0)
    h1 = rng.integers(0, 2**63, 2000, dtype=np.uint64)
    for batch in (h1, h1[:700], np.concatenate([h1[1500:], h1[1500:]]),
                  rng.integers(0, 2**63, 500, dtype=np.uint64)):
        np.testing.assert_array_equal(a.seen_before(batch), b.seen_before(batch))
        assert (a.bloom_probes, a.exact_probes) == (b.bloom_probes, b.exact_probes)
    assert a.filter_efficiency == b.filter_efficiency
    np.testing.assert_array_equal(a.bloom.words, b.bloom.words)
    assert a.exact == b.exact


def test_resumable_data_replays_to_the_resumed_step():
    """``ResumableData`` after serving steps 0-5 and rewinding to 4 (a
    restart) gives an uninterrupted pipeline's batches 4-6 and drops; the
    reference's pipeline, kept across the restart, drops step 4's
    documents as seen and gives another batch."""
    cfg = dict(vocab=512, seq_len=32, global_batch=2, seed=0)
    run, kept = ResumableData(DataConfig(**cfg)), JaxData(JaxDataConfig(**cfg))
    clean = SyntheticLMData(DataConfig(**cfg))
    want = [clean.batch(s) for s in range(7)]
    for s in range(6):
        run.batch(s)
        kept.batch(s)
    for s in (4, 5, 6):
        got = run.batch(s)
        np.testing.assert_array_equal(got["tokens"], want[s]["tokens"])
    assert run.n_dropped == clean.n_dropped
    assert not np.array_equal(kept.batch(4)["tokens"], want[4]["tokens"])
    assert kept.n_dropped == clean.n_dropped + 2
    run.batch(9)                          # a jump ahead replays 7 and 8
    for s in (7, 8, 9):
        clean.batch(s)
    np.testing.assert_array_equal(run.data.dedup.bloom.words,
                                  clean.dedup.bloom.words)


# ------------------------------------------------------------- checkpoint
def _tree():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    return {"params": {"w": w, "layers": [{"ln": np.ones(5, np.float32)},
                                          {"ln": np.ones(5, np.float32)}],
                       "b": rng.normal(size=3).astype(np.float32)},
            "opt": {"step": np.int32(7)}, "step_count": np.int64(5)}


def _as_torch(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _chunks(root):
    d = os.path.join(root, "chunks")
    return {f: open(os.path.join(d, f), "rb").read() for f in os.listdir(d)}


def test_checkpoint_writes_the_jax_stores_bytes(tmp_path):
    """One tree saved by both stores (the port's from tensors): the same
    manifest, chunk files byte for byte, LATEST, and existence-check
    accounting (two identical ``ln`` leaves share a chunk)."""
    a, b = CheckpointStore(str(tmp_path / "port")), JaxStore(str(tmp_path / "jax"))
    for step in (3, 4):
        a.save(step, _as_torch(_tree()))
        b.save(step, _tree())
    for step in (3, 4):
        man = [json.load(open(tmp_path / d / f"step_{step}" / "manifest.json"))
               for d in ("port", "jax")]
        assert man[0] == man[1]
    assert [leaf["key"] for leaf in man[0]["leaves"]] == [
        "opt/step", "params/b", "params/layers/0/ln", "params/layers/1/ln",
        "params/w", "step_count"]
    assert _chunks(tmp_path / "port") == _chunks(tmp_path / "jax")
    assert len(_chunks(tmp_path / "port")) == 5
    assert a.latest_step() == b.latest_step() == 4
    assert (a.stat_calls, a.stat_skipped) == (b.stat_calls, b.stat_skipped)
    assert a.stat_skipped >= 5


def test_checkpoint_crosses_both_ways(tmp_path):
    """The port loads the JAX store's checkpoint into a tensor tree (in
    place, dtypes kept) and the JAX store loads the port's."""
    JaxStore(str(tmp_path / "j")).save(1, _tree())
    like = _as_torch(_tree())
    w = like["params"]["w"]
    w.zero_()
    got = CheckpointStore(str(tmp_path / "j")).load(1, like)
    assert got["params"]["w"] is w               # filled in place
    for key in ("w", "b"):
        np.testing.assert_array_equal(got["params"][key].numpy(),
                                      _tree()["params"][key])
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7
    CheckpointStore(str(tmp_path / "p")).save(2, _as_torch(_tree()))
    back = JaxStore(str(tmp_path / "p")).load(2, _tree())
    assert back["step_count"] == 5 and back["opt"]["step"].dtype == np.int32
    np.testing.assert_array_equal(back["params"]["w"], _tree()["params"]["w"])


def test_checkpoint_load_places_and_refuses(tmp_path):
    """Numpy leaves come back as numpy (the reference's), or as tensors on
    ``device``; a tensor template on another dtype gets a new tensor; a
    bf16 leaf is refused with the reason; the module-level conveniences
    save and load through a fresh store."""
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    out = store.load(1, _tree())
    assert isinstance(out["params"]["w"], np.ndarray)
    out = store.load(1, _tree(), device="cpu")
    assert isinstance(out["params"]["w"], torch.Tensor)
    like = {"params": {"w": torch.zeros(6, 5, dtype=torch.float64)}}
    got = store.load(1, like)["params"]["w"]
    assert got is not like["params"]["w"] and got.dtype == torch.float32
    with pytest.raises(TypeError, match="bfloat16"):
        store.save(2, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert store.latest_step() == latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 3, _as_torch(_tree()))
    back = load_checkpoint(str(tmp_path), latest_step(str(tmp_path)), _tree())
    np.testing.assert_array_equal(back["params"]["w"], _tree()["params"]["w"])


# --------------------------------------------------------------------- ft
def _counting_run(sup_cls, injector_cls, root, fail_at):
    def init_state():
        return {"w": np.float64(0.0), "seen": np.zeros(30, np.int64)}

    def step_fn(state, step):
        state = {"w": state["w"] + step, "seen": state["seen"].copy()}
        state["seen"][step] += 1
        return state, float(step)

    sup = sup_cls(root, save_every=5)
    res = sup.run(init_state=init_state, step_fn=step_fn, n_steps=30,
                  injector=injector_cls(fail_at_steps=fail_at))
    return sup, res, sup.store.load(30, init_state())


def test_supervisor_restart_resumes_exactly(tmp_path):
    """Failures at steps 7, 13 and 22: every step counted once in the
    committed state, the losses and restarts the reference's supervisor
    gives on the same schedule."""
    sup, res, final = _counting_run(Supervisor, FailureInjector,
                                    str(tmp_path / "p"), (7, 13, 22))
    _, jres, _ = _counting_run(JaxSupervisor, JaxInjector, str(tmp_path / "j"),
                               (7, 13, 22))
    assert (res.final_step, res.n_restarts) == (30, 3)
    np.testing.assert_array_equal(final["seen"], np.ones(30))
    assert final["w"] == sum(range(30))
    assert res.losses == jres.losses and res.n_restarts == jres.n_restarts
    assert sup.store.stat_skipped > 0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = Supervisor(str(tmp_path / "ck"), save_every=100, max_restarts=2)
    calls = []

    def bad_step(state, step):
        calls.append(step)
        if step == 1:                   # permanently broken step
            raise InjectedFailure("flaky")
        return state, 0.0

    with pytest.raises(InjectedFailure):
        sup.run(init_state=lambda: {"x": np.zeros(1)}, step_fn=bad_step,
                n_steps=5)
    assert calls == [0, 1] * 3


@pytest.mark.parametrize("scenario", ["outlier", "noise"])
def test_straggler_flags_match_jax(scenario):
    """The same per-step flags as the reference's monitor: a host gone
    slow at step 10 (flagged from step 12), and noise (never flagged)."""
    a, b = StragglerMonitor(n_hosts=8, persist=3), JaxMonitor(n_hosts=8, persist=3)
    rng = np.random.default_rng(0)
    flags = []
    for step in range(30):
        if scenario == "outlier":
            times = {h: 1.0 + 0.01 * h for h in range(8)}
            if step >= 10:
                times[3] = 5.0
        else:
            times = {h: 1.0 + rng.normal() * 0.02 for h in range(8)}
        got = a.record(step, times)
        assert got == b.record(step, times)
        flags.append(got)
    first = next((i for i, f in enumerate(flags) if f), None)
    assert first == (12 if scenario == "outlier" else None)
