"""The port's examples (``examples/*_torch.py``) on the CPU at a small n:
each ``main`` runs to its end, and what it prints about the filters equals
what the JAX package's filters give on the same keys and seeds (exact:
bit counts and decoded characters)."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.core import huffman as JHF  # noqa: E402
from repro.core.chained import ChainedFilterAnd as JAnd  # noqa: E402

EXAMPLES = pathlib.Path(__file__).parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    n = 4000
    _load("quickstart_torch").main(["--device", "cpu", "--n", str(n)])
    out = capsys.readouterr().out
    keys = JH.random_keys(n * 9, seed=1)
    cf = JAnd.build(keys[:n], keys[n:9 * n], seed=7)
    assert (f"ChainedFilter ('&', Alg. 1): {cf.bits / n:.2f} bits/key "
            f"(stage-1 alpha={cf.f1.alpha}, {cf.n_false_pos} stage-2 "
            "whitelists)") in out
    assert "chained_probe on cpu matches the host filter on 1024 keys" in out


def test_huffman_compress_torch_runs_on_the_cpu(capsys):
    mod = _load("huffman_compress_torch")
    mod.main(["--device", "cpu", "--n", "4000"])
    out = capsys.readouterr().out
    text = JHF.exponential_text(8, 4000, seed=0)
    ref = JHF.RandomAccessHuffman.build(text, seed=1)
    assert f"ChainedFilter RA:    {ref.bits_per_char():.3f} bits/char" in out
    assert "decode of 1000 positions on cpu: all correct" in out
    # the batched decode against the reference's one-position decode
    ra = mod.RandomAccessHuffman.build(text, seed=1)
    idx = np.arange(0, 4000, 97, dtype=np.uint64)
    assert mod.decode_batch(ra, idx, "cpu") == [ref.decode_at(int(i))
                                                for i in idx]


def test_serve_lm_torch_runs_on_the_cpu(capsys):
    """The reference's serving example on the port: 24 requests over 6
    prompts through the prefix cache (the smoke llama at f32)."""
    s = _load("serve_lm_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] arch=llama3.2-1b requests=24 tokens=192" in out
    assert s["prefill_tokens_saved_frac"] > 0.5 and s["wasted_probes"] == 0


def test_train_lm_torch_runs_on_the_cpu(capsys):
    """The reference's training example on the port at 20 steps: a
    failure injected at step 10 and resumed, the loss down."""
    res = _load("train_lm_torch").main(["--steps", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res.n_restarts == 1 and res.final_step == 20
    assert "survived 1 injected failure(s); final loss" in out
    assert res.losses[-1] < res.losses[0]


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device is usable")
    for name in ("quickstart_torch", "huffman_compress_torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main(["--n", "200"])


def test_lm_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("serve_lm_torch").main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("train_lm_torch").main(["--steps", "2"])
