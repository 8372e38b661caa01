"""Port parity, slice 12: the SSM hybrid, RWKV6 and the encoder-decoder
run sharded over a ``DeviceMesh``, on the CPU.

Two gloo ranks (``tests/_torch_ranks.py``: the ``steps_zamba2``,
``steps_rwkv`` and ``steps_whisper`` jobs, started at once) run each
family's ``build_cell(..., mesh=)`` steps on a (1, 2) mesh under
``DEFAULT_RULES`` (rwkv6 under ``SP_RULES`` too: its layers take their
sequence-split input whole, so each rank scans its own heads) from
numpy weights at f32, the train cells with remat: a train step from a
carried AdamW state, a 12-token prefill (whisper's beside its frame
embeddings) and 2 decode steps, through the sharded scans (``by_rows_and_heads``
over ``_ssd_chunk`` and ``_chunk_wkv``), the placed caches and the
weight gathers. Meanwhile this process runs the one-device port's cells
and the JAX reference (``_torch_ranks.jax_reference``: its
``build_cell(..., make_host_mesh())`` train step, ``jax.grad`` of its
loss, its model's prefill and decode steps) on the same inputs, and
each result is held to both.

A fourth job, ``one_rank``, runs every family's smoke steps at bf16 on
a 1-rank (1, 1) mesh beside the one-device steps (the CPU twin of the
card's ``test_sharded_steps_on_card_match_one_device``): equal bit for
bit.

Tolerances, as ``test_torch_train.py``: the loss within 1e-6 relative;
gradient leaves within 1e-5 relative L2, whisper's within 1e-4 (at
random init its cross-attention is near uniform over the frames, and
the gradients of its q/k projections and of the norm before it are
small differences of large terms: on those leaves the one-device
port's f32 gradients are up to 2.5e-5 from the reference's in relative
L2, and the sharded step's up to 2.3e-5 from the port's and 3.4e-5 from
the reference's); params,
AdamW moments, logits and caches within 1e-5 (absolute and relative).
Placements and byte counts: exact."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import _torch_ranks as R  # noqa: E402
from repro_torch.models import common as C  # noqa: E402

CASES = {c[0]: c for c in R.FAMILY_CASES}
GRAD_REL = {"whisper_1x2": 1e-4}
JOBS = {"zamba2-2.7b": "steps_zamba2", "rwkv6-7b": "steps_rwkv",
        "whisper-tiny": "steps_whisper"}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return [R.start_ranks(job, 2, tmp_path_factory.mktemp(job))
            for job in JOBS.values()] + [
        R.start_ranks("one_rank", 1, tmp_path_factory.mktemp("one_rank"))]


@pytest.fixture(scope="module")
def refs(started):
    """{tag: [the one-device port's results, the JAX reference's]},
    computed while the ranks run, once an arch (its cases differ only in
    the mesh's rules)."""
    was = C.COMPUTE_DTYPE
    C.set_compute_dtype(torch.float32)
    try:
        of = {}
        for _, arch_id, *_, serve in R.FAMILY_CASES:
            if arch_id not in of:
                of[arch_id] = [R.port_reference(arch_id, serve),
                               R.jax_reference(arch_id, serve)]
        return {tag: of[arch_id] for tag, arch_id, *_ in R.FAMILY_CASES}
    finally:
        C.set_compute_dtype(was)


@pytest.fixture(scope="module")
def ranks(started, refs):
    return R.collect(started)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_train_step_matches_one_device_and_the_reference(
        tag, ranks, refs):
    """The loss, grad_norm, every param and AdamW leaf after one step, and
    every gradient leaf of the step's batch, against the one-device port
    and the JAX reference (its train step; ``jax.grad`` of its loss)."""
    R.check_train(ranks, tag, refs[tag],
                  grad_rel=GRAD_REL.get(tag, R.GRAD_REL))


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_prefill_and_decode_match_one_device_and_the_reference(
        tag, ranks, refs):
    """The prefill's logits, each decode step's logits and the cache after
    the last step (Zamba2's conv tails, SSM states and attention ring,
    RWKV6's token shifts and WKV states, whisper's K/V and encoder
    memory), against the one-device port and the JAX reference."""
    R.check_serve(ranks, tag, CASES[tag][4], refs[tag])


@pytest.mark.parametrize("tag", list(CASES))
def test_placed_arguments_carry_the_rules_placements(tag, ranks):
    """Every argument and result leaf at its spec's placements; the local
    bytes of the placed train and decode arguments equal
    ``Cell.arg_local_bytes()``."""
    R.check_placed(ranks, tag, CASES[tag][4])


@pytest.mark.parametrize("arch_id", R.ONE_RANK_ARCHS)
def test_steps_on_one_rank_equal_one_device(arch_id, ranks):
    """Each family's smoke steps on a 1-rank gloo (1, 1) mesh at bf16
    compute (the CPU twin of the card's
    ``test_sharded_steps_on_card_match_one_device``): the train step's
    loss, params and AdamW state, a 12-token prefill's and 2 decode
    steps' logits equal the one-device steps' bit for bit. Where no rank
    splits a weight, the sharded step runs the one-device step's ops."""
    assert ranks[f"{arch_id}_train_equal"]
    assert ranks[f"{arch_id}_serve_equal"]
