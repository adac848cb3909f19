"""Distribution layer: the worker list, synchronous data parallelism
and SparkNet's τ-local SGD, with the communication layer under both.

Counterpart of the dp part of ``sparknet_tpu/parallel``: the JAX
package's device mesh is an explicit list of worker devices here
(:func:`make_workers`), and its collectives are functions over that
worker axis (:mod:`.comm`), or ``all_reduce`` over a process group when
each worker is a process (:mod:`.multihost`). Tensor, sequence,
pipeline and expert parallelism, the rule-table layouts and resharding
are not ported.
"""

from .mesh import DP_AXIS, make_workers
from .comm import CommConfig, resolve_config
from .data_parallel import make_dp_eval_step, make_dp_train_step
from .local_sgd import (
    RESIDUAL_KEY,
    RoundBuffer,
    init_local_opt_state,
    init_local_residual,
    make_local_scan,
    make_round_reduce,
    stack_round_batches,
    worker_rows,
)
from .tau_controller import TauController
from .trainer import ParallelSolver
from . import comm

__all__ = [
    "comm",
    "DP_AXIS",
    "CommConfig",
    "ParallelSolver",
    "RESIDUAL_KEY",
    "RoundBuffer",
    "TauController",
    "init_local_opt_state",
    "init_local_residual",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_local_scan",
    "make_round_reduce",
    "make_workers",
    "resolve_config",
    "stack_round_batches",
    "worker_rows",
]
