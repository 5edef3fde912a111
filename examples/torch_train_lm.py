"""LM training on the port, with an elastic restart (the port's
``examples/train_lm.py``): trains a ~100M-parameter granite-family model
on the synthetic bigram stream with asynchronous checkpoints, then
restores the latest checkpoint and continues, replaying the stream from
the saved step.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
        [--device cpu]

On the card by default (attention through the flash kernel under
autograd); ``--device cpu`` trains on the CPU through the plain
attention.  The checkpoints go to a temporary directory, removed at the
end.
"""
import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.lm_data import bigram_ce_floor, lm_batch, step_generator
from repro_torch.data.pipeline import ShardedFeed
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import elastic_restore
from repro_torch.launch.train import TrainState, train_loop
from repro_torch.models.model import Model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # ~100M params: the granite family, narrowed as the reference's example
    cfg = dataclasses.replace(
        get_config("granite-3-2b"),
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=8192, max_position_embeddings=2048)
    print(f"model: {cfg.param_count() / 1e6:.0f}M params on {dev} "
          f"(CE floor ≈ {bigram_ce_floor(cfg.vocab_size):.2f} nats)")
    model = Model(cfg, ParallelConfig(use_flash_attention=dev.type == "cuda"),
                  device=dev, seed=args.seed)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=args.steps // 10,
                       total_steps=args.steps)

    def feed(start):
        return ShardedFeed(
            lambda s: lm_batch(step_generator(args.seed, s), args.batch,
                               args.seq, cfg.vocab_size),
            device=dev, start_step=start)

    ckpt_dir = tempfile.mkdtemp(prefix="torch_train_lm_ckpt_")
    try:
        manager = CheckpointManager(ckpt_dir, keep_latest=2)
        f = feed(0)
        try:
            train_loop(model, tcfg, f, manager=manager,
                       ckpt_every=max(args.steps // 3, 1), log_every=25)
        finally:
            f.close()

        print("\nelastic restart: restoring the latest checkpoint ...")
        restored, meta = elastic_restore(manager, model)
        resume = meta["step"]
        print(f"restored step {resume}; continuing 10 more steps")
        f = feed(resume)
        try:
            train_loop(model, dataclasses.replace(
                tcfg, total_steps=resume + 10), f, log_every=5,
                state=TrainState(params=restored["params"],
                                 opt=restored["opt"], step=resume))
        finally:
            f.close()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("done.")


if __name__ == "__main__":
    main()
