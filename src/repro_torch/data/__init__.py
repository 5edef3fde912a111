"""Synthetic data: the causal DGPs (``causal_dgp``, ``event_dgp``), the
LM token streams (``lm_data``) and the sharded batch feed (``pipeline``)."""
from repro_torch.data.causal_dgp import CausalData, make_causal_data  # noqa: F401
from repro_torch.data.lm_data import lm_batch_stream, synthetic_tokens  # noqa: F401
from repro_torch.data.pipeline import ShardedFeed  # noqa: F401
