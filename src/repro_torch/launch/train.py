"""End-to-end training driver with fault tolerance, the JAX package's
``launch/train.py`` on the port: the deterministic resume-exact data
pipeline, checkpoint and restart, and the train step
(``dist/steps.py``), on one process or on the ranks of the default
process group where one is initialised.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --steps 200 --seq-len 256 --global-batch 16 --ckpt-dir /tmp/ckpt [--device cpu]

``--device`` defaults to the CUDA card and raises without one. The step's
key is ``fold_in(PRNGKey(seed + 1), i)``; a run with ``--ckpt-dir`` resumes
from its ``latest`` checkpoint and asserts that the data pipeline is at
the restored step. The parameters are random from ``--seed``
(``api.init_params``: a ``torch.Generator``, not JAX's draws).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ckpt as CKPT
from repro_torch import configs
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.dist import sharding as SH
from repro_torch.dist import steps as ST
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def main(argv=None):
    """Run the training loop. Prints the ``[train]`` lines and the summary
    JSON and returns the summary, with the run's ``losses``,
    ``grad_norms``, ``step_s`` (host seconds a step, each ending in a
    device sync), and the trained ``model`` and ``opt_state`` for callers
    that go on with them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-sync", default="auto", choices=["auto", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for tests")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        over = {}
        if args.n_layers:
            over["n_layers"] = args.n_layers
        if args.d_model:
            over["d_model"] = args.d_model
        cfg = configs.reduced(cfg, **over)
    dev = resolve_device(args.device)
    ctx = SH.make_ctx(dist.group.WORLD if dist.is_initialized() else None)
    print(f"[train] arch={cfg.arch} family={cfg.family} "
          f"mesh={{'data': {ctx.size}, 'model': 1}}")

    model = api.trainable(api.init_params(cfg, args.seed, dev))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 1))
    params = dict(model.named_parameters())
    opt_state = adamw.init(params)
    n_params = sum(int(np.prod(p.shape)) for p in params.values())
    print(f"[train] {n_params/1e6:.1f}M params")

    # --- fault tolerance: resume from the latest checkpoint ---------------
    start_step = 0
    if args.ckpt_dir:
        latest = CKPT.latest_step(args.ckpt_dir)
        if latest is not None:
            (saved, opt_state), manifest = CKPT.restore(
                args.ckpt_dir, ({k: p.detach() for k, p in params.items()}, opt_state))
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
            start_step = manifest["step"]
            print(f"[train] resumed from step {start_step}")

    data = SyntheticLM(cfg.vocab, args.seq_len, args.global_batch, seed=args.seed)
    prefetch = Prefetcher(data, start_step=start_step)
    step_fn = ST.make_train_step(cfg, ctx, opt_cfg, microbatches=args.microbatches,
                                 grad_sync=args.grad_sync)

    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for i in range(start_step, args.steps):
        step_i, batch = next(prefetch)
        assert step_i == i, f"data pipeline desync: {step_i} != {i}"
        rng = prng.fold_in(prng.PRNGKey(args.seed + 1), i)
        ts = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, batch, rng)
        losses.append(float(metrics["loss"]))  # waits for the step's device work
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - ts)
        if (i + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {i+1}: loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} gnorm={gnorms[-1]:.3f} "
                  f"({dt/args.log_every:.2f}s/step)")
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0 and ctx.rank == 0:
            CKPT.save(args.ckpt_dir, i + 1,
                      ({k: p.detach() for k, p in params.items()}, opt_state),
                      extra={"loss": losses[-1]})
            print(f"[train] checkpointed step {i+1}")
    prefetch.close()

    out = {"final_loss": losses[-1], "first_loss": losses[0],
           "steps": args.steps, "params_m": n_params / 1e6}
    print(json.dumps(out))
    return dict(out, losses=losses, grad_norms=gnorms, step_s=step_s, model=model,
                opt_state=opt_state)


if __name__ == "__main__":
    main()
