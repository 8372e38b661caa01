"""End-to-end driver on the PyTorch + CUDA port: train a small LM for a
few hundred steps with the full production substrate — filter-dedup'd
data pipeline, train step, AdamW, atomic checkpoints, injected node
failure + restart, straggler monitor. The loss must go down and the
injected failure must not change the trajectory (determinism across
restarts). On the card by default (bf16 compute); ``--device cpu`` runs
the plain versions at f32.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 40 --device cpu
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    d1 = tempfile.mkdtemp(prefix="repro_train_")
    try:
        res = train_main(["--arch", args.arch, "--steps", str(args.steps),
                          "--ckpt-dir", d1, "--save-every", "20",
                          "--fail-at", str(args.steps // 2),
                          "--device", args.device])
        print(f"survived {res.n_restarts} injected failure(s); "
              f"final loss {res.losses[-1]:.3f}")
    finally:
        shutil.rmtree(d1, ignore_errors=True)
    return res


if __name__ == "__main__":
    main()
