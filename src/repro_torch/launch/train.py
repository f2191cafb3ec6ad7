"""LM training launcher.

Port of ``repro.launch.train``: the JAX CLI's flags, defaults and
behaviour, plus ``--device`` (``cuda`` by default; ``cpu`` on request).
On the GPU the model runs at the full width and depth of ``--arch``
(zamba2-1.2b: 38 layers, d_model 2048, 1.10 G float32 parameters) with
random weights made from ``--seed`` on the card; ``--reduced`` gives the
small variant. The batches are ``data/pipeline.py``'s Markov-Zipf stream,
the JAX package's batches exactly. Checkpoint / restart (``--ckpt-dir``,
``--ckpt-every``, ``--resume``) go through ``training/checkpoint.py``'s
train-state format, which the JAX package reads and writes. Microbatching,
remat and int8 error-feedback gradient compression over the data-parallel
world (``--grad-compression``; ``torch.distributed`` when a process group
is up, a world of one otherwise) are the reference's.

Two places where the port rightly differs from the JAX CLI: on
``--resume`` the token stream is fast-forwarded past the steps already
taken (JAX's restarts it from its first batch), and the error-feedback
residuals of ``--grad-compression`` are part of the state from the first
step, so that they are checkpointed and restored (JAX's restore target
lacks them and restarts them at zero). So a resumed run is the straight
run bit for bit.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --steps 10 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-0.5b --reduced --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-0.5b --reduced --steps 50 --resume --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.compression import (compress_psum, ef_init,
                                              world_size)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.train_step import (init_train_state,
                                             make_loss_fn, make_train_step,
                                             value_and_grad)


def make_compressed_step(model, opt_cfg: AdamWConfig, remat: bool):
    """The data-parallel train step with the int8 error-feedback gradient
    all-reduce over the default group: (state with "ef", local batch) ->
    (state, metrics). As in the reference, no microbatching and no
    rejected-update guard here."""
    import torch.distributed as dist
    loss_fn = make_loss_fn(model, remat=remat)
    world = world_size()

    def step(state, batch):
        (loss, extras), grads = value_and_grad(loss_fn, state["params"],
                                               batch)
        grads, new_res = compress_psum(grads, state["ef"])
        new_params, new_opt, om = adamw_update(
            opt_cfg, state["params"], grads, state["opt"])
        if world > 1:
            dist.all_reduce(loss)
            loss = loss / world
        return ({"params": new_params, "opt": new_opt, "ef": new_res},
                {"loss": loss, **extras, **om})

    return step


def main(argv=None, params=None, history=None):
    """Run the launcher; returns the final train state. ``params``: a
    starting parameter tree of numpy arrays (the JAX package's, e.g.)
    instead of the seeded init. ``history``: a list that gets each step's
    metrics (tensors, no host synchronization)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # full float32 on the card, as on the CPU (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr,
                          warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    if args.grad_compression:
        step_fn = make_compressed_step(model, opt_cfg, not args.no_remat)
    else:
        step_fn = make_train_step(model, opt_cfg,
                                  microbatches=args.microbatches,
                                  remat=not args.no_remat)

    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        state = init_train_state(model, gen)
    else:
        p = params_from_numpy(cfg, params, dev)
        state = {"params": p, "opt": adamw_init(p)}
    if args.grad_compression:
        state["ef"] = ef_init(state["params"])
    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = ckpt.restore_tree(args.ckpt_dir, last, state)
            start = last
            print(f"resumed from step {last}")

    pipe = iter(TokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                              device=dev))
    for _ in range(start):      # the batches of the steps already taken
        next(pipe)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(pipe)
        state, metrics = step_fn(state, batch)
        if history is not None:
            history.append(metrics)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["loss"])
            tok_s = args.batch * args.seq * (step + 1 - start) / (
                time.time() - t0)
            print(f"step {step + 1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  tok/s {tok_s:,.0f}",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, ckpt.tree_flat(state),
                      extra={"arch": args.arch, "reduced": args.reduced})
    # the final state, unless the loop has just written it (the reference
    # writes that step twice, the same bytes)
    if args.ckpt_dir and not (args.steps > start
                              and args.steps % args.ckpt_every == 0):
        ckpt.save(args.ckpt_dir, args.steps, ckpt.tree_flat(state),
                  extra={"arch": args.arch, "reduced": args.reduced})
    print("done")
    return state


if __name__ == "__main__":
    main()
