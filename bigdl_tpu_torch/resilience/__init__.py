"""Fault tolerance of the port (counterpart of
``bigdl_tpu.resilience``): the trainers' retry policy and its error
classes, the serving router's retry budget, the fault injector
(``BIGDL_TORCH_FAULT_PLAN``) and the elastic layer: preemption,
heartbeats, the world-resize resume (``elastic.ensure_shard_layout``),
``restore_latest`` and the stream's resume; the restart supervisor
(``python -m bigdl_tpu_torch.resilience.supervisor -- CMD``) and its
autoscaling policy loop (``resilience/autoscale.py``)."""

from bigdl_tpu_torch.resilience.autoscale import (AutoscaleController,
                                                  Decision)
from bigdl_tpu_torch.resilience.elastic import (EXIT_FATAL, EXIT_PREEMPTED,
                                                EXIT_TRANSIENT,
                                                ElasticSession,
                                                HeartbeatMonitor, Preempted,
                                                clear_preemption,
                                                ensure_shard_layout,
                                                install_preemption_handler,
                                                preemption_requested,
                                                record_resume,
                                                request_preemption,
                                                restore_latest,
                                                restore_stream, run_main)
from bigdl_tpu_torch.resilience.faults import (Fault, FaultInjector,
                                               FaultPlan, InjectedFault,
                                               get_injector, reset_injector)
from bigdl_tpu_torch.resilience.retry import (FATAL_TYPES,
                                              CheckpointWriteError,
                                              NonFiniteStepError,
                                              PeerLostError, RetryBudget,
                                              RetryPolicy, backoff_delay,
                                              classify)
from bigdl_tpu_torch.resilience.supervisor import HangWatchdog, Supervisor

__all__ = ["CheckpointWriteError", "NonFiniteStepError", "PeerLostError",
           "RetryBudget", "RetryPolicy", "backoff_delay", "classify",
           "Fault", "FaultInjector", "FaultPlan", "InjectedFault",
           "get_injector", "reset_injector", "restore_stream",
           "EXIT_FATAL", "EXIT_PREEMPTED", "EXIT_TRANSIENT",
           "ElasticSession", "HeartbeatMonitor", "Preempted",
           "ensure_shard_layout", "record_resume", "restore_latest",
           "run_main", "FATAL_TYPES", "preemption_requested",
           "request_preemption", "clear_preemption",
           "install_preemption_handler", "AutoscaleController", "Decision",
           "HangWatchdog", "Supervisor"]
