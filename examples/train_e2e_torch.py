"""End-to-end training example of the PyTorch port (the twin of
``train_e2e.py``): a reduced MiniCPM-family model trained on the synthetic
corpus for 120 steps at batch 8 x 128, with a checkpoint every 40 steps
and auto-resume, through ``repro_torch.launch.train``.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 120]
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu

It runs on the GPU unless ``--device`` says otherwise, and checks that
the training nll falls over a run that starts from step 0.
``--ckpt-dir`` keeps the checkpoints there (by default a fresh temporary
directory), and a run given a directory that holds one resumes from it;
``--stop-at`` ends the run after that step, as a run cut short would.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--stop-at", type=int, default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_e2e")
    extra = [] if args.device is None else ["--device", args.device]
    if args.stop_at is not None:
        extra += ["--stop-at", str(args.stop_at)]
    history = train_main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--lr", "1e-3", "--warmup", "20",
        "--ckpt-dir", ckpt, "--ckpt-every", "40",
        "--log-every", "10", *extra,
    ])
    if len(history) >= 2 and history[0]["step"] == 1:   # not resumed
        first, last = history[0]["nll"], history[-1]["nll"]
        if not last < first:
            raise SystemExit(f"loss did not improve: {first} -> {last}")
        print(f"\n[e2e] OK: nll {first:.3f} -> {last:.3f}; "
              f"checkpoints in {ckpt}")
    return history


if __name__ == "__main__":
    main()
