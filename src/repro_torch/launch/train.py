"""LM training: the train step, the loop and its CLI (the reference's
``launch/train.py``).

``make_train_step(model, tcfg)`` returns ``train_step(params, opt,
batch) -> (params, opt, metrics)``: forward + CE through the model's
``loss_fn``, gradient accumulation over ``parallel.microbatch`` splits
of the batch in ``parallel.grad_accum_dtype`` (divided by their count),
optional gradient compression (``parallel.gradient_compression``), the
cosine schedule, and AdamW with global-norm clipping.  ``params`` is the
flat {state_dict path: fp32 tensor} dict and ``opt`` the AdamW state
({"step", "m", "v"} over the same paths).  At step start every matrix
(ndim >= 2) is cast once to the compute dtype and the forward reads the
casts, while the gradients flow back to the fp32 masters, as the
reference casts before its FSDP gathers.  The step updates ``params``
and ``opt`` IN PLACE and returns them (the reference donates both to its
jitted step): no second copy of the weights or moments is made.  metrics:
loss, ce, aux, grad_norm (before clipping), lr; over microbatches, their
means.

``train_loop`` runs the step over a feed (``data/pipeline.ShardedFeed``
of ``data/lm_data`` batches), logs, and saves {"params", "opt"} with
``CheckpointManager.save_async`` every ``ckpt_every`` steps;
``launch/elastic.elastic_restore`` brings such a state back.

    python -m repro_torch.launch.train --arch granite-3-2b --steps 20

runs on the card (attention through the flash kernel) unless
``--device cpu`` is given, as the reference's CLI does: under a host
mesh (``launch/mesh.make_host_mesh``: every rank on the data axis)
with ``default_rules(fsdp=False)``, the state placed by
``launch/elastic.state_shardings`` and each batch split over the ranks
(``data/pipeline.batch_sharding``).  The default process group comes
from ``torchrun``'s environment, else it is this process alone: NCCL on
the card (one rank a card), gloo on the CPU —

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu

On DTensors the flash kernel runs on each rank's shard of the batch and
the heads (``models/attention._maybe_flash``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.distributed.sharding import whole_sums
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, unflatten
from repro_torch.optim.adamw import adamw_init, adamw_update_
from repro_torch.optim.compression import compress_decompress
from repro_torch.optim.schedule import cosine_schedule

Tensor = torch.Tensor
_F32 = torch.float32


def loss_and_grads(model: Model, params: Dict[str, Tensor],
                   batch: Dict[str, Tensor]
                   ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """(metrics {loss, ce, aux}, gradients {path: tensor}) of one batch
    at ``params``: the matrices cast to the compute dtype once, the
    batch split into ``parallel.microbatch`` parts whose gradients are
    summed in ``parallel.grad_accum_dtype`` and divided by their count
    (fp32 sums accumulate in the leaves' own ``.grad``), the metrics
    averaged over the parts (on DTensors, their partial sums reduced
    first: a mean over a batch split across ranks is whole on every
    rank)."""
    pcfg, ct = model.parallel, model.cfg.compute_dtype
    m, acc_dt = pcfg.microbatch, pcfg.grad_accum_dtype
    place = _grad_placer(model)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    sums: Dict[str, Tensor] = {}
    gsum: Optional[Dict[str, Tensor]] = None
    for i in range(m):
        mb = batch if m == 1 else {
            k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
            for k, v in batch.items()}
        cast = unflatten({k: (x.to(ct) if x.dim() >= 2 else x)
                          for k, x in leaves.items()})
        loss, parts = model.loss_fn(**mb, params=cast)
        del cast
        loss.backward()
        for k, v in {"loss": loss, **parts}.items():
            v = whole_sums(v.detach())
            sums[k] = sums[k] + v if k in sums else v
        if m > 1 and acc_dt != _F32:
            g = place({k: x.grad.to(acc_dt) for k, x in leaves.items()})
            gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
            for x in leaves.values():
                x.grad = None
    if gsum is None:
        gsum = place({k: x.grad for k, x in leaves.items()})
    del leaves
    if m == 1:
        return sums, gsum
    return ({k: v / m for k, v in sums.items()},
            {k: g / m for k, g in gsum.items()})


def _grad_placer(model: Model):
    """Gradients laid out as their parameters' specs under
    ``model.rules`` (the reference constrains its grad accumulator so:
    a partial sum becomes a reduce-scatter onto the FSDP shards, not an
    all-reduce to full size); without rules, or outside a mesh, the
    gradients themselves."""
    if model.rules is None:
        return lambda grads: grads
    from repro_torch.distributed.sharding import constrain_to
    specs = flatten(model.param_specs(model.rules))
    return lambda grads: {k: constrain_to(g, specs[k])
                          for k, g in grads.items()}


def make_train_step(model: Model, tcfg: TrainConfig):
    """The train step of ``model`` under ``tcfg``; see the module
    docstring."""
    pcfg = model.parallel

    def train_step(params: Dict[str, Tensor], opt: Dict[str, Any],
                   batch: Dict[str, Tensor]):
        metrics, grads = loss_and_grads(model, params, batch)
        if pcfg.gradient_compression != "none":
            grads = {k: compress_decompress(g, pcfg.gradient_compression)
                     for k, g in grads.items()}
        lr = cosine_schedule(opt["step"], peak=tcfg.learning_rate,
                             warmup=tcfg.warmup_steps,
                             total=tcfg.total_steps)
        params, opt, om = adamw_update_(grads, opt, params, lr, tcfg)
        return params, opt, {**metrics, **om}

    return train_step


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Tensor]
    opt: Dict[str, Any]
    step: int = 0


def init_state(model: Model) -> TrainState:
    """Step 0: the model's own weights as the flat {path: tensor} dict
    (the state_dict's tensors, sharing their storage: training them in
    place trains the model) and zero moments in
    ``parallel.adam_moment_dtype``."""
    params = dict(model.state_dict())
    return TrainState(params=params, opt=adamw_init(
        params, model.parallel.adam_moment_dtype))


def place_state(state: TrainState, shardings: Dict[str, Any]
                ) -> TrainState:
    """``state`` with every leaf a ``DTensor`` under ``shardings``
    (``launch/elastic.state_shardings``); each rank holds the whole
    state before, so nothing crosses between ranks."""
    from repro_torch.distributed.sharding import distribute
    sh, opt = shardings, state.opt
    return TrainState(
        params={k: distribute(v.detach(), sh["params"][k])
                for k, v in state.params.items()},
        opt={"step": distribute(opt["step"], sh["opt"]["step"]),
             **{m: {k: distribute(v, sh["opt"][m][k])
                    for k, v in opt[m].items()} for m in ("m", "v")}},
        step=state.step)


def train_loop(model: Model, tcfg: TrainConfig, feed, *,
               manager: Optional[CheckpointManager] = None,
               ckpt_every: int = 0, log_every: int = 10,
               state: Optional[TrainState] = None,
               log=print) -> TrainState:
    """Train until ``tcfg.total_steps`` (or the feed ends) from
    ``state`` (``init_state(model)`` if None); every ``ckpt_every``
    steps save {"params", "opt"} asynchronously with the step's loss as
    its metric.  Returns the final state."""
    if state is None:
        state = init_state(model)
    step_fn = make_train_step(model, tcfg)
    t0 = time.time()
    for batch in feed:
        state.params, state.opt, metrics = step_fn(state.params, state.opt,
                                                   batch)
        state.step += 1
        if log_every and state.step % log_every == 0:
            log(f"step {state.step:5d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"{(time.time() - t0) / log_every:.3f}s/step")
            t0 = time.time()
        if manager is not None and ckpt_every and \
                state.step % ckpt_every == 0:
            manager.save_async(state.step,
                               {"params": state.params, "opt": state.opt},
                               metric=float(metrics["loss"]))
        if state.step >= tcfg.total_steps:
            break
    if manager is not None:
        manager.wait()
    return state


def _open_default_group(device: torch.device) -> bool:
    """Open the default process group unless one is open: from
    ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) when it is set, else a group of this process alone.
    NCCL on the card (rank i on card LOCAL_RANK), gloo on the CPU.
    Returns whether it opened one."""
    import os

    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def main(argv=None) -> int:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import (bigram_ce_floor, lm_batch,
                                          step_generator)
    from repro_torch.data.pipeline import ShardedFeed, batch_sharding
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import (default_rules,
                                                  dtensor_ops, mesh_context)
    from repro_torch.launch.elastic import state_shardings
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    opened = _open_default_group(dev)
    feed = None
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        cfg = get_config(args.arch)
        mesh = make_host_mesh()
        rules = default_rules(fsdp=False)
        pcfg = ParallelConfig(fsdp=False, microbatch=args.microbatch,
                              use_flash_attention=dev.type == "cuda")
        model = Model(cfg, pcfg, rules, device=dev, seed=args.seed)
        tcfg = TrainConfig(learning_rate=args.lr,
                           warmup_steps=args.steps // 10,
                           total_steps=args.steps)
        state = place_state(init_state(model),
                            state_shardings(model, rules, mesh))
        feed = ShardedFeed(
            lambda s: lm_batch(step_generator(args.seed, s), args.batch,
                               args.seq, cfg.vocab_size),
            sharding=batch_sharding(mesh))
        manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        log(f"training {args.arch} on {dev} under a {tuple(mesh.shape)} "
            f"host mesh: vocab {cfg.vocab_size}, CE floor ≈ "
            f"{bigram_ce_floor(cfg.vocab_size):.3f} nats")
        with mesh_context(mesh), dtensor_ops():
            train_loop(model, tcfg, feed, manager=manager,
                       ckpt_every=args.ckpt_every, state=state, log=log)
    finally:
        if feed is not None:
            feed.close()
        if opened:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
