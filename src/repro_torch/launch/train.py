"""Training launcher: a seeded model trained on synthetic data, or the
dry-run of a production cell.

The counterpart of ``repro.launch.train``.  It runs on the card unless
``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 3 --batch 2 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --steps 4 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --shape train_4k --dry-run        # the meta-device cell, no step

``--distributed-init`` first joins the process group the launcher's
environment describes (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``): ``nccl`` on the card, ``gloo`` with ``--device cpu``.
Each process then trains its own replica.
"""
from __future__ import annotations

import argparse
import time

import torch


def _allocated(dev: torch.device) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def train(model, opt, data, steps: int, *, state=None, on_step=None):
    """``steps`` steps of ``make_train_step`` from the model's parameters
    on ``data``'s batches 0, 1, ...; ``state`` is the optimizer's (its
    ``init`` by default), ``on_step(i, loss, seconds)`` is called after
    each step.  Installs the trained parameters in ``model`` and returns
    each step's loss."""
    from ..train.step import make_train_step
    from ..tree import tree_map
    step_fn = make_train_step(model, opt)
    params = tree_map(lambda p: p.detach(), model.params.to_dict())
    dev = model.params["embed"].device
    if state is None:
        state = opt.init(params)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i).items()}
        t0 = time.monotonic()
        params, state, metrics = step_fn(params, state, batch, i)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss, dt)
    model.set_params(params)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="build the production cell on meta tensors")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-executable)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--distributed-init", action="store_true",
                    help="join the process group of the launcher's "
                         "environment")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        from .dryrun import main as dryrun_main
        return dryrun_main(["--arch", args.arch, "--shape", args.shape]
                           + (["--multi-pod"] if args.multi_pod else []))

    from ..configs import ARCHS, reduce_cfg
    from ..core.device import resolve_device
    from ..data import DataCfg, SyntheticLM
    from ..models import build_model
    from ..optim import OptCfg, make_optimizer
    from ..tree import tree_leaves, tree_map
    dev = resolve_device(args.device)
    dist = None
    if args.distributed_init:
        import torch.distributed as dist
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        print(f"rank {dist.get_rank()} of {dist.get_world_size()}")

    spec = ARCHS[args.arch]
    cfg = reduce_cfg(spec.cfg) if args.reduced else spec.cfg
    if cfg.frontend != "none" or cfg.encdec:
        cfg = cfg.replace(frontend="none", n_frontend_tokens=0,
                          encdec=False)
    model = build_model(cfg)
    opt = make_optimizer(OptCfg())
    before = _allocated(dev)
    model.init(torch.Generator(device=dev).manual_seed(0), dev)
    params = tree_map(lambda p: p.detach(), model.params.to_dict())
    state = opt.init(params)
    grown = _allocated(dev) - before
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq=args.seq,
                               global_batch=args.batch))
    n = sum(p.numel() for p in tree_leaves(params))
    held = (f"; parameters and optimizer state {grown} bytes on the card"
            if dev.type == "cuda" else "")
    print(f"{args.arch}: {n / 1e6:.1f}M params on {dev}{held}")

    def on_step(i, loss, dt):
        print(f"  step {i}: loss={loss:.4f} ({dt:.2f}s)")

    train(model, opt, data, args.steps, state=state, on_step=on_step)
    if dist is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
