"""Quickstart: train a tiny GPT-2 for 30 steps, then serve it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference's ``examples/quickstart.py`` on the port: the reduced gpt2-124m
config, weights from a seeded ``torch.Generator``, 30 AdamW steps of 4 x 64
tokens through the port's train step, then two requests through
``ServingEngine``. Runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticSource, to_device
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.train_step import TrainStepConfig, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("gpt2-124m").reduced()
    model = build_model(cfg, args.device)
    params, _ = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    opt = adamw.init(params)
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), 4, 64)
    step = make_train_step(model, TrainStepConfig(opt=opt_cfg))

    print("training…")
    for i in range(30):
        params, opt, metrics = step(params, opt,
                                    to_device(pipe.batch_at(i), model.device))
        loss = float(metrics["loss"])
        if i % 10 == 0:
            print(f"  step {i:3d} loss {loss:.3f}")
    print(f"  final loss {loss:.3f}")

    print("serving…")
    engine = ServingEngine(model, params, slots=2, max_seq=96)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(3, 17, dtype=np.int32)]
    out = engine.run([Request(i, p, 8) for i, p in enumerate(prompts)])
    for rid, toks in sorted(out.items()):
        print(f"  request {rid}: generated {toks}")


if __name__ == "__main__":
    main()
