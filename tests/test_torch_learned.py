"""Port parity, the §5.5 learned filter (``repro_torch.core.learned``) on
the CPU against the JAX package. The dataset is the reference's numpy,
equal array for array. The score model's initial weights cannot match
``jax.random``, so its pieces are held with the JAX weights carried
across (``params_from_numpy``): logits and loss within 1e-6, gradients
(against ``jax.grad``) within 1e-6 absolute / 1e-5 relative, one Adam
step within 1e-6 (the reference's bias correction is f32 under ``jit``,
the port's f64 on the host); the whole build is held to the §5.5
figures with the tolerances of ``chip_smoke.py``'s phase 10."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import learned as J  # noqa: E402
from repro_torch.core import LearnedFilter, synth_url_dataset  # noqa: E402
from repro_torch.core import learned as P  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _jax_loss(params, x, y):
    """The reference's loss (``train_score_model``'s ``loss_fn``)."""
    lg = J._mlp_logits(params, x)
    return jnp.mean(jnp.maximum(lg, 0) - lg * y
                    + jnp.log1p(jnp.exp(-jnp.abs(lg))))


@pytest.mark.parametrize("args", [(1500, 1500, 16, 0.05, 2),
                                  (700, 300, 8, 0.2, 5)])
def test_synth_url_dataset_is_the_reference(args):
    for got, want in zip(synth_url_dataset(*args), J.synth_url_dataset(*args)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _carried(n=600, seed=4):
    keys, feats, labels = J.synth_url_dataset(n // 2, n // 2, seed=seed)
    jp = J._init_mlp(16, 16, jax.random.PRNGKey(seed))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return feats, labels, jp, p


def test_logits_loss_and_gradient_match_jax():
    feats, labels, jp, p = _carried()
    x, y = torch.from_numpy(feats), torch.from_numpy(labels.astype(np.float32))
    jx, jy = jnp.asarray(feats), jnp.asarray(labels.astype(np.float32))
    np.testing.assert_allclose(P._mlp_logits(p, x).numpy(),
                               np.asarray(J._mlp_logits(jp, jx)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(P._loss(p, x, y)),
                               float(_jax_loss(jp, jx, jy)), rtol=1e-6)
    jg = jax.grad(_jax_loss)(jp, jx, jy)
    g = P._grads(p, x, y)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)


def test_one_adam_step_matches_jax():
    """The reference's ``train_score_model(steps=1)`` starts from
    ``_init_mlp(PRNGKey(seed))``; the port's step from the same weights."""
    feats, labels, jp, p = _carried()
    want = J.train_score_model(feats, labels, steps=1, seed=4)
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    got, m, v = P._adam_step(p, zeros, dict(zeros), 1, torch.from_numpy(feats),
                             torch.from_numpy(labels.astype(np.float32)), 1e-2)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    assert all(float(v[k].min()) >= 0 for k in v)


def test_threshold_and_scores_match_jax():
    """``pick_threshold`` equal on the same scores; ``model_scores`` of
    carried weights within 1e-6."""
    feats, labels, jp, p = _carried()
    scores = P.model_scores(p, feats)
    np.testing.assert_allclose(scores, J.model_scores(jp, feats),
                               rtol=1e-6, atol=1e-6)
    for fpr in (0.01, 0.1, 0.5):
        assert P.pick_threshold(scores[~labels], fpr) == \
            J.pick_threshold(scores[~labels], fpr)
    assert P.pick_threshold(scores[:0], 0.01) == 0.0


def test_learned_chained_filter_invariants():
    """The mirror of tests/test_applications.py's, on the port."""
    keys, feats, labels = synth_url_dataset(1500, 1500, seed=2)
    lf = LearnedFilter.build(keys, feats, labels, backup_kind="chained",
                             model_fpr=0.01, seed=3, device="cpu")
    got = lf.query(keys, feats)
    assert got[labels].all(), "false negative in learned chained filter"
    fpr = got[~labels].mean()
    assert fpr <= 0.05, fpr
    lb = LearnedFilter.build(keys, feats, labels, backup_kind="bloom",
                             model_fpr=0.01, seed=3, device="cpu")
    gotb = lb.query(keys, feats)
    assert gotb[labels].all()
    assert got[~labels].sum() <= gotb[~labels].sum() + 5
    assert lf.model_bits == lb.model_bits == (16 * 16 + 16 + 16 + 1) * 32
    with pytest.raises(ValueError):
        LearnedFilter.build(keys, feats, labels, backup_kind="cuckoo",
                            device="cpu")


@pytest.mark.parametrize("frac", [0.1, 1.0])
def test_learned_cell_at_n_3000_holds_the_reference_figures(frac):
    """``chip_smoke.learned_cell`` at n = 3,000 (the Motivation table's
    rows): 0 false negatives, chained fpr ≤ 0.012, chained bits within 15%
    of the JAX package's and below the bloom backup's."""
    cs = _chip_smoke()
    rows = cs.learned_cell(3000, (frac,), "cpu")
    assert [r["kind"] for r in rows] == list(cs.LEARNED_KINDS)
    assert cs.learned_faults(rows) == []
    chained = rows[-1]
    assert chained["fpr"] <= cs.LEARNED_FPR_MAX
    # a broken row is caught
    rows[-1] = dict(chained, fn=1, bits=rows[0]["bits"] + 1)
    assert len(cs.learned_faults(rows)) == 3
