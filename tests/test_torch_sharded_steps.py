"""Port parity, slice 12: the LM train, prefill and decode steps run
sharded over a ``DeviceMesh`` (``launch/steps.py`` with a mesh,
``sharding/ctx.py``, DTensor params, AdamW state and caches), on the CPU.

Two gloo ranks (``tests/_torch_ranks.py``: the ``steps`` job for the
smoke llama, ``steps_moe`` for the deepseek-v2-lite and internvl2
smokes, ``supervisor`` for a sharded trainer, all three started at once)
run ``build_cell(..., mesh=)`` steps from numpy weights at f32: the
llama's train step on (2, 1) and (1, 2) under ``DEFAULT_RULES`` and on
(1, 2) under ``SP_RULES``, its prefill and 4 decode steps on (1, 2); the
deepseek's (experts over ``model``) train step, prefill and 2 decode
steps on (1, 2) under ``DEFAULT_RULES`` and ``SP_RULES`` (MLA's absorbed
scores split over ``model`` by head) and its train step on (2, 1);
internvl2's train step on
(2, 1); smoke llamas with one kv head, and with 3 kv heads for 6 q
heads (``steps_gqa``: the ``model`` axis divides neither), on (1, 2);
``moe_block`` alone on (2, 1), its groups split over the data
ranks. Meanwhile this process runs the one-device port's cells and the
JAX reference (``_torch_ranks.jax_reference``: its
``build_cell(..., make_host_mesh())`` train step, ``jax.grad`` of its
loss, its model's prefill and decode steps) on the same inputs.

Tolerances, as ``test_torch_train.py``: the loss within 1e-6 relative;
gradient leaves within 1e-5 relative L2; params, AdamW moments, logits
and caches within 1e-5 (absolute and relative): the same f32 arithmetic
summed in another order (a product over a split dim sums its partial
sums). Placements, byte counts, step counts and the resumed losses:
exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)


import _torch_ranks as R  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding.rules import DEFAULT_RULES  # noqa: E402

CASES = {c[0]: c for c in R.STEP_CASES}
SERVE = [tag for tag, *_, serve in R.STEP_CASES if serve is not None]


@pytest.fixture(autouse=True)
def _port_f32_compute():
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    yield
    C.set_compute_dtype(was)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both rank jobs, started before the references are computed."""
    return [R.start_ranks(job, 2, tmp_path_factory.mktemp(job))
            for job in ("steps", "steps_moe", "supervisor", "steps_gqa")]


def _inputs(arch_id):
    """The one-device port's smoke model of ``arch_id``, its numpy params,
    carried AdamW state and inputs (those of the rank jobs)."""
    m = get_arch(arch_id).model(smoke=True, remat=True, q_chunk=512)
    npp = R.np_params(m, R.STEP_SEED)
    return m, npp, R.carried_opt(npp), R.step_inputs(m, arch_id)


def _batch(inp, lib):
    return {k: lib(v) for k, v in inp["batch"].items()}


@pytest.fixture(scope="module")
def refs(started):
    """{arch: (one-device port, JAX reference, serve)}, computed once an
    arch while the ranks run (a train case's references do not depend on
    its mesh; an arch's serve steps are those of its case that has
    some)."""
    serve_of: dict = {}
    for tag, arch_id, *_, serve in R.STEP_CASES + R.GQA_CASES:
        serve_of[arch_id] = serve_of.get(arch_id) or serve
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    try:
        return {a: (R.port_reference(a, s), R.jax_reference(a, s), s)
                for a, s in serve_of.items()}
    finally:
        C.set_compute_dtype(was)


@pytest.fixture(scope="module")
def ranks(started, refs):
    """Rank 0's results of the three jobs; rank 1's must equal them."""
    return R.collect(started)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_train_step_matches_one_device_and_the_reference(
        tag, ranks, refs):
    """The loss, grad_norm, every param and AdamW leaf after one step, and
    every gradient leaf of the step's batch, against the one-device port
    and the JAX reference (its train step; ``jax.grad`` of its loss)."""
    port, ref, _ = refs[CASES[tag][1]]
    R.check_train(ranks, tag, [port, ref])


@pytest.mark.parametrize("tag", SERVE)
def test_sharded_prefill_and_decode_match_one_device_and_the_reference(
        tag, ranks, refs):
    """The prefill's logits, each decode step's logits and the cache after
    the last step, against the one-device port and the JAX reference."""
    port, ref, serve = refs[CASES[tag][1]]
    assert int(ranks[f"{tag}/cache/len"]) == sum(serve)
    R.check_serve(ranks, tag, serve, [port, ref])


@pytest.mark.parametrize("case", R.GQA_CASES, ids=lambda c: c[0])
def test_sharded_steps_where_model_does_not_divide_the_kv_heads(
        case, ranks, refs):
    """Grouped-query attention with the q heads split over ``model`` and
    the kv heads whole (1 or 3 kv heads on a (1, 2) mesh: the rules
    replicate them): the train step, the prefill and 2 decode steps
    against the one-device port and the JAX reference, every argument
    and result placed by its spec (``common._sharded_gqa``: each rank's q
    heads read the kv head each maps to)."""
    tag, arch_id, dims, *_, serve = case
    port, ref, _ = refs[arch_id]
    assert port["/params/layers/0/attn/wk"].shape[1] % dims[1] != 0
    R.check_train(ranks, tag, [port, ref])
    R.check_serve(ranks, tag, serve, [port, ref])
    R.check_placed(ranks, tag, serve)


@pytest.mark.parametrize("first, n, g, want", [
    (0, 4, 8, slice(0, 1)),           # 1 kv head, 8 q heads on 2 ranks
    (4, 4, 8, slice(0, 1)),
    (0, 4, 2, slice(0, 2)),           # whole groups: the plain grouping
    (4, 4, 2, slice(2, 4)),
    (0, 3, 2, [0, 0, 1]),             # 3 kv heads, 6 q heads on 2 ranks
    (3, 3, 2, [1, 2, 2]),
    (2, 2, 4, slice(0, 1)),           # part of one group
    (1, 4, 2, [0, 1, 1, 2]),
])
def test_kv_heads_of_maps_each_q_head_to_its_kv_head(first, n, g, want):
    """``common._kv_heads_of``: q heads ``first`` .. ``first + n - 1``
    read kv head ``h // g`` each, as a slice where that is the plain
    grouping of consecutive kv heads, else an index per q head."""
    got = C._kv_heads_of(first, n, g)
    if isinstance(want, slice):
        assert got == want
    else:
        assert isinstance(got, torch.Tensor) and got.tolist() == want
    # what the local product reads: each picked kv head for n / (their
    # count) consecutive q heads
    picked = C._pick_heads(torch.arange(8).reshape(1, 1, 8, 1), got)
    read = picked.repeat_interleave(n // picked.shape[2], dim=2)
    assert read.flatten().tolist() == [(first + j) // g for j in range(n)]


@pytest.mark.parametrize("tag", list(CASES))
def test_placed_arguments_carry_the_rules_placements(tag, ranks):
    """``Cell.place`` puts every argument leaf at ``placements(mesh,
    spec)`` of ``Cell.arg_specs``, the step returns params and AdamW state
    placed the same way (its out shardings), and the local shards' bytes
    are ``Cell.arg_local_bytes()`` (a decode cell's too, its cache's
    host-int length counted as the reference's int32 scalar)."""
    R.check_placed(ranks, tag, CASES[tag][4])


def test_sharded_supervisor_resumes_bit_for_bit(ranks):
    """``build_trainer(mesh=)`` on (2, 1) under the supervisor: a failure
    at step 6 resumes from step 4's checkpoint (saved as full values by
    rank 0, restored placed) and gives the uninterrupted run's losses bit
    for bit; those equal the one-device trainer's within 1e-5."""
    clean, failed = ranks["sup_clean_losses"], ranks["sup_failed_losses"]
    fail, every = R.SUP_FAIL_AT[0], R.SUP_SAVE_EVERY
    resume = fail // every * every
    assert (int(ranks["sup_clean_restarts"]),
            int(ranks["sup_failed_restarts"])) == (0, 1)
    assert len(clean) == R.SUP_STEPS
    np.testing.assert_array_equal(
        failed, np.concatenate([clean[:fail], clean[resume:]]))
    init_state, step_fn, _ = train.build_trainer("llama3.2-1b", smoke=True,
                                                 device="cpu")
    state, one = init_state(), []
    for s in range(R.SUP_STEPS):
        state, loss = step_fn(state, s)
        one.append(loss)
    np.testing.assert_allclose(clean, one, rtol=1e-5)


def test_moe_block_routes_each_ranks_own_groups(ranks):
    """``moe_block`` on (2, 1) inside a step's context: with 2 groups each
    data rank routes, dispatches and combines its own (its 2 batch rows;
    the reference keeps its groups split over the batch), with 1 group
    every rank routes the whole batch (4 rows). Either way the output and
    the gradients of the input and of every weight equal the one-device
    block's, with tokens dropped at an expert's capacity in the first."""
    split, whole = R.MOE_GROUP_SIZES
    assert list(ranks[f"moe_{split}_rows"]) == [R.MOE_BATCH // 2]
    assert list(ranks[f"moe_{whole}_rows"]) == [R.MOE_BATCH]
    assert ranks[f"moe_{split}_dropped"] > 0
    for gs in (split, whole):
        got = [ranks[f"moe_{gs}_got_{i}"] for i in range(6)]
        want = [ranks[f"moe_{gs}_want_{i}"] for i in range(6)]
        assert f"moe_{gs}_got_6" not in ranks
        np.testing.assert_allclose(got[0], want[0], **R.TOL)
        for i in range(1, 6):
            assert R.rel_l2(got[i], want[i]) <= R.GRAD_REL, (gs, i)


def test_matmul_f32_on_dtensors_places_its_product(ranks):
    """``matmul_f32`` of DTensors under ``local_map``: a contraction over
    the split dim (both operands split on K, or only ``a``) gives a
    ``Partial`` sum, ``b`` split on N an output split on N; each equal to
    the plain product."""
    assert ranks["mm_contract_placements"] == "(Replicate(), Partial(sum))"
    assert ranks["mm_a_on_k_placements"] == "(Replicate(), Partial(sum))"
    assert ranks["mm_columns_placements"] == "(Replicate(), Shard(dim=1))"
    for name in ("contract", "a_on_k", "columns"):
        assert ranks[f"mm_{name}_err"] <= 1e-6


def test_shard_activation_without_and_within_a_context():
    """Outside a context ``shard_activation`` returns ``x`` itself (the
    reference's ``test_shard_activation_noop_without_ctx``); contexts
    nest and the inner one wins; inside one a plain tensor is refused
    with a ``TypeError`` that names its axes."""
    x = torch.ones(4, 4)
    assert ctx.current() is None
    assert ctx.shard_activation(x, ("batch", None)) is x
    outer, inner = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    with ctx.activation_sharding_ctx(outer, DEFAULT_RULES):
        with ctx.activation_sharding_ctx(inner, DEFAULT_RULES):
            assert ctx.current()[0] is inner
            with pytest.raises(TypeError, match=r"\('batch', None\)"):
                ctx.shard_activation(x, ("batch", None))
        assert ctx.current()[0] is outer
    assert ctx.current() is None
    assert ctx.zeros_placed(lambda d: {"a": x}, {"a": ("batch", None)},
                            "cpu")["a"] is x


def test_one_device_steps_build_no_dtensor_and_enter_no_context():
    """Without a mesh the train, prefill and decode cells run as before:
    no context is entered and no result is a DTensor."""
    from torch.distributed.tensor import DTensor
    seen = []
    m, npp, opt, inp = _inputs("llama3.2-1b")
    loss = m.loss
    m.loss = lambda p, b: (seen.append(ctx.current()), loss(p, b))[1]
    cell = steps.build_cell(get_arch("llama3.2-1b"), "train_4k",
                            device="cpu", smoke=True, model=m)
    p = C.params_from_numpy(npp, "cpu")
    res = cell.step(p, C.params_from_numpy(opt, "cpu"),
                    _batch(inp, torch.from_numpy))
    pcell = steps.build_cell(get_arch("llama3.2-1b"), "prefill_32k",
                             device="cpu", smoke=True)
    res += pcell.step(p, R.serve_batch(inp, 12, torch.from_numpy))
    assert seen == [None]
    assert not any(isinstance(t, DTensor) for t in C.tree_leaves(res))
