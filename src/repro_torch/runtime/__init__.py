"""Fault tolerance of the port: failure injection against the drain path,
the heartbeat ledger and the restart loop (``runtime/fault.py``), and the
elastic re-mesh of a training run (``runtime/elastic.py``)."""
from repro_torch.runtime.elastic import (ElasticDecision, build_mesh,
                                         elastic_restore, plan_remesh)
from repro_torch.runtime.fault import (FaultPlan, HeartbeatLedger,
                                       InjectedFault, NodeFailure,
                                       RestartPolicy, StragglerReport,
                                       run_with_restarts)

__all__ = ["ElasticDecision", "FaultPlan", "HeartbeatLedger",
           "InjectedFault", "NodeFailure", "RestartPolicy",
           "StragglerReport", "build_mesh", "elastic_restore", "plan_remesh",
           "run_with_restarts"]
