"""The port's train step over D gloo ranks on the CPU, for
tests/test_torch_train_step.py.

``python tests/torch_train_ranks.py D OUT`` starts D rank processes (spawn)
that meet through a ``FileStore`` in a fresh temporary directory; each
builds ``step_case``'s model and batch, takes its train steps with a
``ShardCtx`` over the group, and writes its parameters, loss and grad norm
to ``OUT`` as ``rank<r>.npz`` beside the path (a directory). The launcher
waits ``RANK_TIMEOUT_S`` at most for its ranks and ends any still running;
the test kills the launcher itself at its own limit. Imports no jax.
"""
import multiprocessing
import os
import sys
import tempfile
import traceback

import numpy as np

RANK_TIMEOUT_S = 150.0
#: the case every rank and the one-process run take: reduced smollm-360m
#: in f32, batch 4 x 32 of the synthetic stream, two microbatches, two steps
CASE = dict(arch="smollm-360m", seq_len=32, batch=4, microbatches=2, steps=2)


def step_case(ctx) -> dict:
    """Run CASE's steps under ``ctx``; the parameters after them (name ->
    array), and each step's loss and grad norm."""
    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.utils import prng

    cfg = configs.reduced(configs.get_config(CASE["arch"]))
    model = api.trainable(api.init_params(cfg, 0, "cpu"))
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, ctx, adamw.AdamWConfig(warmup_steps=1, total_steps=4),
                              microbatches=CASE["microbatches"])
    data = SyntheticLM(cfg.vocab, CASE["seq_len"], CASE["batch"], seed=0)
    out = {}
    for i in range(CASE["steps"]):
        opt, m = step(model, opt, data.batch_at(i), prng.fold_in(prng.PRNGKey(1), i))
        out[f"loss{i}"] = np.float32(m["loss"].item())
        out[f"gnorm{i}"] = np.float32(m["grad_norm"].item())
    out.update({f"p.{k}": p.detach().numpy().copy() for k, p in model.named_parameters()})
    return out


def rank_main(rank: int, size: int, store: str, out_dir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.dist import sharding as SH

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            res = step_case(SH.make_ctx(dist.group.WORLD))
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    except Exception:  # the launcher reports a rank's failure with its traceback
        with open(os.path.join(out_dir, f"rank{rank}.error"), "w") as f:
            f.write(traceback.format_exc())


def main(size: int, out: str) -> int:
    os.makedirs(out, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=rank_main, args=(r, size, store, out))
                 for r in range(size)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ok = not late and all(os.path.exists(os.path.join(out, f"rank{r}.npz"))
                          for r in range(size))
    if late:
        print(f"late ranks: {late}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
