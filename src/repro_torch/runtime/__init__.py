"""Fault tolerance of the port: failure injection against the drain path,
the heartbeat ledger and the restart loop (``runtime/fault.py``; the
reference's ``runtime/elastic.py`` needs a mesh and comes with the
multi-GPU slice)."""
from repro_torch.runtime.fault import (FaultPlan, HeartbeatLedger,
                                       InjectedFault, NodeFailure,
                                       RestartPolicy, StragglerReport,
                                       run_with_restarts)

__all__ = ["FaultPlan", "HeartbeatLedger", "InjectedFault", "NodeFailure",
           "RestartPolicy", "StragglerReport", "run_with_restarts"]
