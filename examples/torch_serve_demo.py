"""Batched LM serving demo on the PyTorch/CUDA port (the NEXUS deployment
path): one wave of requests prefills once through the model's kernels,
then decodes lock-step against the KV cache and recurrent states.

    PYTHONPATH=src python examples/torch_serve_demo.py [--arch granite-3-2b]
                                                       [--device cpu]

On the CUDA card by default, at the architecture's full width and depth
(random weights from the seed); ``--device cpu`` serves its ``-smoke``
variant through the plain versions.  Architectures: granite-3-2b,
rwkv6-3b, zamba2-1.2b.
"""
import argparse
import time

import torch

from repro_torch.config import ParallelConfig
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models.model import Model


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    arch = args.arch + ("-smoke" if dev.type == "cpu" else "")
    cfg = get_config(arch)
    model = Model(cfg, ParallelConfig(use_flash_attention=True), device=dev,
                  seed=0)
    server = BatchServer(model, max_seq=128)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (16,), generator=gen)
               for _ in range(args.requests)]
    reqs = [Request(p, max_new_tokens=args.new_tokens) for p in prompts]

    t0 = time.perf_counter()
    outs = server.serve_wave(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(o.tokens) for o in outs)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"{cfg.name}: served {args.requests} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s on {where})")
    for i, o in enumerate(outs):
        print(f"  req{i}: {o.tokens}")


if __name__ == "__main__":
    main()
