"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-124m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-124m --full-size \
        --attn-impl xla_cv --batch 8 --seq 1024 --steps 30

Composes: config -> reduced-or-full model -> slice allocation (partitioner)
-> data pipeline -> fault-tolerant runner (checkpoint/restart, straggler
tracking) -> AdamW train step, as the reference's ``launch/train.py`` does. Runs on the
CUDA device unless ``--device cpu`` is given. ``--attn-impl xla_cv`` routes
attention through the hand-written flash forward and backward kernels
(``xla``, the eager chunked version, is the config's default); ``--remat``
takes the config's values (none, layer, full, offload). Without
``--ckpt-dir`` the run checkpoints into a temporary directory that is removed
at its end.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import StaticPartitioner
from repro_torch.core.slices import get_profile
from repro_torch.data.pipeline import (ByteCorpusSource, DataPipeline,
                                       SyntheticSource, to_device)
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.fault import (FaultTolerantRunner, RunnerConfig,
                                     RunnerStats, StepFailure)
from repro_torch.train.train_step import (TrainStepConfig, make_train_step,
                                          metrics_to_floats)

REMATS = ("none", "layer", "full", "offload")


def build_config(arch: str, *, full_size: bool, attn_impl: Optional[str] = None,
                 remat: Optional[str] = None) -> ModelConfig:
    """The full config, or the reduced one cut to at most 4 layers (CPU)."""
    cfg = get_config(arch)
    if not full_size:
        cfg = cfg.reduced().with_(num_layers=min(cfg.num_layers, 4))
    if attn_impl:
        cfg = cfg.with_(attn_impl=attn_impl)
    if remat:
        cfg = cfg.with_(remat=remat)
    return cfg


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float,
          device="cuda", ckpt_dir: str, ckpt_every: int,
          inject_failure_at: int = -1, corpus: Optional[str] = None,
          seed: int = 0, log_every: int = 0) -> RunnerStats:
    """Train ``cfg`` for ``steps`` steps through the fault-tolerant runner.
    Weights come from a seeded ``torch.Generator``; a failure injected at
    ``inject_failure_at`` fails one chip of the slice, so the runner
    restores the newest checkpoint and moves to another slice."""
    model = build_model(cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    train_step = make_train_step(model, TrainStepConfig(opt=opt_cfg))
    source = (ByteCorpusSource(corpus) if corpus
              else SyntheticSource(cfg.vocab_size, seed=0))
    pipe = DataPipeline(source, batch, seq, device=model.device)
    current = [0]

    def get_batch(step):
        current[0] = step
        return pipe.batch_at(step)

    def build_step(profile):
        gen = torch.Generator(device=model.device).manual_seed(seed)
        params, _ = model.init(gen)
        state = {"params": params, "opt": adamw.init(params)}
        if ckpt_mod.latest_step(ckpt_dir) is not None:
            state, _ = ckpt_mod.restore(ckpt_dir, state)

        def step(state, batch_np):
            p, o, met = train_step(state["params"], state["opt"],
                                   to_device(batch_np, model.device))
            met = metrics_to_floats(met)      # waits for the step's work
            if log_every and (current[0] + 1) % log_every == 0:
                print(f"step {current[0] + 1}: loss {met['loss']:.4f} "
                      f"lr {met['lr']:.3e} grad_norm {met['grad_norm']:.3f}",
                      flush=True)
            return {"params": p, "opt": o}, met
        return step, state

    part = StaticPartitioner()
    profile = get_profile("1s.16c")
    part.allocate(profile, tag="train")
    pending_failure = [inject_failure_at]  # fire exactly once

    def fail_hook(step):
        if step == pending_failure[0]:
            pending_failure[0] = -1
            part.fail_chips([(0, 0)])
            raise StepFailure(f"injected chip failure at step {step}")

    runner = FaultTolerantRunner(
        RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        part, profile, build_step, get_batch=get_batch,
        save_state=lambda s: s, fail_hook=fail_hook)
    return runner.run(steps)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-124m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced, 4 layers)")
    ap.add_argument("--corpus", default=None, help="byte-level corpus file")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a step failure (tests restart path)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", choices=("xla", "xla_cv"), default=None,
                    help="xla_cv: the hand-written flash kernels, forward and "
                         "backward (default: the config's)")
    ap.add_argument("--remat", choices=REMATS, default=None,
                    help="default: the config's")
    args = ap.parse_args()

    cfg = build_config(args.arch, full_size=args.full_size,
                       attn_impl=args.attn_impl, remat=args.remat)
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_train_"))
        t0 = time.time()
        stats = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      lr=args.lr, device=args.device, ckpt_dir=ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      inject_failure_at=args.inject_failure_at,
                      corpus=args.corpus, log_every=args.log_every)
        wall = time.time() - t0
    step_s = float(np.median(stats.step_seconds)) if stats.step_seconds else 0.0
    print(f"arch={cfg.name} attn_impl={cfg.attn_impl} remat={cfg.remat} "
          f"steps={stats.steps_done} wall={wall:.1f}s "
          f"loss {stats.losses[0]:.3f} -> {np.mean(stats.losses[-10:]):.3f} "
          f"step_median={step_s * 1e3:.1f}ms "
          f"tok/s={args.batch * args.seq / step_s if step_s else 0:.0f} "
          f"restarts={stats.restarts} stragglers={stats.straggler_events} "
          f"repartitions={stats.repartitions}")


if __name__ == "__main__":
    main()
