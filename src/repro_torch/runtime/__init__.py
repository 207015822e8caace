"""Fault tolerance: heartbeats, stragglers, the restart driver (port of
``repro.runtime``)."""

from repro_torch.runtime.faults import (FailureInjector, HeartbeatMonitor,
                                        RestartPolicy, run_with_restarts)

__all__ = ["FailureInjector", "HeartbeatMonitor", "RestartPolicy",
           "run_with_restarts"]
