"""The CUDA probe kernels on the card, each held against its plain torch
version (exact equality: integer outputs). Needs a CUDA device and nvcc;
skips elsewhere. This file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402
from repro_torch.kernels.bloom_probe import bloom_probe  # noqa: E402
from repro_torch.kernels.lsm_probe import (chain_descriptors,  # noqa: E402
                                           lsm_chain_probe, lsm_probe)
from repro_torch.storage import LsmStore  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", range(len(selfcheck.edge_cases())),
                         ids=[f"{k}:{n}" for k, n, _ in selfcheck.edge_cases()])
def test_kernel_matches_plain_version(cuda, case):
    kernel, _, arg = selfcheck.edge_cases()[case]
    counter = {"lsm_probe": lsm_probe, "lsm_chain_probe": lsm_chain_probe,
               "bloom_probe": bloom_probe}[kernel]
    before = counter.launches
    if kernel == "lsm_probe":
        bad = selfcheck.check_lsm_probe(arg, cuda)
    elif kernel == "lsm_chain_probe":
        bad = selfcheck.check_lsm_chain_probe(arg, cuda)
    else:
        bad = selfcheck.check_bloom_probe(cuda)
    torch.cuda.synchronize()
    assert bad == 0
    assert counter.launches == before + 1


@pytest.mark.parametrize("kind", ["chained", "bloom", "none"])
def test_store_on_card_matches_store_on_cpu(cuda, kind):
    keys = H.random_keys(40_000, seed=3)
    stores = [LsmStore(filter_kind=kind, memtable_capacity=3000, seed=7,
                       bits_per_key=9.0, device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(1)
    for i in range(10):
        ks = keys[i * 2500:(i + 1) * 2500]
        dead = rng.choice(keys[:(i + 1) * 2500], 300, replace=False)
        for s in stores:
            s.put_batch(ks, ks >> np.uint64(5))
            s.delete_batch(dead)
    q = np.concatenate([keys[:25_000], keys[-10_000:]])
    before = lsm_probe.launches
    got, want = stores[0].get_batch(q), stores[1].get_batch(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lsm_probe.launches == before + 1
    assert stores[0].stats.as_dict()["sstable_reads"] == \
        stores[1].stats.as_dict()["sstable_reads"]
    if kind != "none":
        m_gpu, p_gpu = stores[0].service.probe(q)
        m_cpu, p_cpu = stores[1].service.probe(q)
        np.testing.assert_array_equal(m_gpu, m_cpu)
        np.testing.assert_array_equal(p_gpu, p_cpu)


def test_kernels_reject_what_they_cannot_take(cuda):
    tables, chains, _, _ = selfcheck.edge_bank(("fuse",), per=200)
    words = torch.from_numpy(tables.view(np.int32).copy()).to(cuda)
    desc = torch.from_numpy(chain_descriptors(chains)).to(cuda)
    hi = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # key lanes on another device
        lsm_probe(words, hi, hi.cpu(), desc, chains=chains)
    with pytest.raises(ValueError):        # descriptors on another device
        lsm_probe(words, hi, hi, desc.cpu(), chains=chains)
    with pytest.raises(ValueError):
        lsm_probe(words, hi, hi, desc.repeat(33, 1), chains=chains * 33)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    first, mask = lsm_probe(words, empty, empty, desc, chains=chains)
    assert first.numel() == mask.numel() == 0
