"""The Dream11 scenario (paper §4) on the PyTorch/CUDA port: users are
described by event sequences, a frozen LM backbone pools each sequence
into features, and those features are the confounders of a 5-fold
cross-fit DML with a delete-fold jackknife interval.

A user's sequence encodes a latent engagement score that confounds both
the treatment (a promo) and the outcome (deposits); the true effect is
2.0.  The backbone is untrained (weights from the port's init on a
seeded generator), as in ``examples/causal_backbone.py``, whose default
backbone, rwkv6-3b, is this one's too.

    PYTHONPATH=src python examples/torch_causal_backbone.py \\
        [--arch rwkv6-3b | zamba2-1.2b | granite-3-2b] [--users 8192] \\
        [--seq 64] [--device cpu]

Runs on the CUDA card by default, through the hand-written kernels
(GLA scan for rwkv6, SSD scan and flash attention for zamba2, flash
attention for granite, segment-Gram for the DML heads); ``--device cpu``
runs the plain versions (use a ``-smoke`` arch there, e.g.
``--arch rwkv6-3b-smoke``).
"""
import argparse
import time

import torch

from repro_torch.config import CausalConfig, ParallelConfig
from repro_torch.configs import get_config
from repro_torch.core.dml import DML
from repro_torch.core.nuisance import backbone_features
from repro_torch.data.event_dgp import make_event_data
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--arch", default="rwkv6-3b",
                help="backbone config (suffix -smoke: the reduced variant)")
# more users than backbone features (d_model up to 2560), or the ridge heads
# over-fit the confounders
ap.add_argument("--users", type=int, default=8192)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--batch", type=int, default=256,
                help="sequences per backbone forward")
ap.add_argument("--device", default=None, help="default: the CUDA card")
ap.add_argument("--seed", type=int, default=0)
args = ap.parse_args()

dev = resolve_device(args.device)
cfg = get_config(args.arch)
model = Model(cfg, ParallelConfig(use_flash_attention=True), device=dev,
              seed=args.seed)
data = make_event_data(args.users, args.seq, cfg.vocab_size, seed=args.seed,
                       device=dev)
y, t = data.y, data.t

naive = float((y * t).sum() / t.sum() - (y * (1 - t)).sum() / (1 - t).sum())
print(f"naive difference-in-means  : {naive:+.3f}   (true effect +2.000)")

print(f"embedding {args.users} user sequences with {cfg.name} "
      f"({cfg.num_layers} layers, d_model {cfg.d_model}) on {dev} ...")
t0 = time.perf_counter()
feats = backbone_features(model, data.tokens, batch_size=args.batch)
feats = (feats - feats.mean(0)) / (feats.std(0, correction=0) + 1e-6)
if dev.type == "cuda":
    torch.cuda.synchronize()
print(f"features in {time.perf_counter() - t0:.2f} s")

cfg_c = CausalConfig(n_folds=5, nuisance_y="ridge", nuisance_t="logistic",
                     engine="parallel", inference="jackknife")
res = DML(cfg_c, device=dev).fit(y, t, feats)
lo, hi = res.ate_interval()
print(f"DML over backbone features : {res.ate:+.3f} "
      f"± {float(res.stderr[0]):.3f}  (jackknife 95% CI [{lo:.3f}, {hi:.3f}])")
print(res.summary())
