"""repro_torch.inference — batched bootstrap / jackknife inference.

EconML's ``BootstrapInference`` runs B full re-estimations as Ray tasks;
here the B replicates are one batched program dispatched by an executor
(``serial | vmap | shard_map``), every weighted Gram of a microbatch one
launch of the segment-Gram kernel on the card.  ``numerics`` holds the
batch-invariant weighted fits behind serial ≡ batched, bitwise; the
pairs and multiplier / Bayesian bootstraps, the delete-fold jackknife
and the percentile / normal / studentized intervals build on them.
``VmapExecutor`` is the reference's name of ``BatchedExecutor``.
"""
#   executor.py   the Executor protocol + backends (the Ray-pool analogue)
#   numerics.py   batch-invariant weighted fits (serial == batched bitwise)
#   bootstrap.py  pairs + multiplier/Bayesian bootstrap over the executor
#   jackknife.py  delete-fold jackknife from the existing fold states
#   intervals.py  percentile / normal / studentized CIs, InferenceResult
from repro_torch.inference.executor import (  # noqa: F401
    Executor, SerialExecutor, VmapExecutor, BatchedExecutor,
    ShardMapExecutor, make_executor)
from repro_torch.inference.intervals import (  # noqa: F401
    InferenceResult, percentile_interval, normal_interval,
    studentized_interval, z_crit)
from repro_torch.inference.bootstrap import (  # noqa: F401
    bootstrap_weights, dml_theta_once, dml_residuals_once, dml_bootstrap,
    dr_bootstrap, dr_theta_once, iv_theta_once, iv_residuals_once,
    iv_bootstrap, driv_theta_once, driv_bootstrap)
from repro_torch.inference.jackknife import (  # noqa: F401
    delete_fold_jackknife, delete_fold_jackknife_iv)
