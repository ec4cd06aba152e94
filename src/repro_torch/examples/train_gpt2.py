"""Train gpt2-124m, the paper's own llm.c training workload (Table III),
through the port's training entry point, with checkpointing and fault-tolerant
restart.

    PYTHONPATH=src python -m repro_torch.examples.train_gpt2 [--tiny] [--steps N]

By default the full gpt2-124m config trains for 200 steps on the CUDA device
with attention through the hand-written flash kernels (``--attn-impl
xla_cv``); ``--tiny`` is a reduced 4-layer sanity run, ``--device cpu`` runs
on the CPU.
"""
import argparse
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "gpt2-124m",
           "--steps", str(args.steps),
           "--batch", str(args.batch),
           "--seq", str(args.seq),
           "--device", args.device,
           "--attn-impl", "xla_cv"]
    if not args.tiny:
        cmd.append("--full-size")
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
