"""Runtime substrate: telemetry hub, span tracer, metrics registry, the
fault injector and the fault-tolerant loop (the reference package's
`runtime`, whose names it exports)."""
from .faults import (FaultEvent, FaultInjector,  # noqa: F401
                     FaultPlan, InjectedFault, active_injector)
from .ft import (FaultTolerantLoop, StragglerWatchdog,  # noqa: F401
                 elastic_remesh)
from .metrics import (MetricsRegistry, default_metrics,  # noqa: F401
                      set_default_metrics)
from .telemetry import (ArrivalEstimator, CostLedger,  # noqa: F401
                        LedgerEntry, ResidualTracker, Telemetry,
                        TimingRing, default_telemetry,
                        set_default_telemetry)
from .trace import (Tracer, default_tracer,  # noqa: F401
                    set_default_tracer)

__all__ = [
    "ArrivalEstimator", "CostLedger", "LedgerEntry", "ResidualTracker",
    "Telemetry", "TimingRing",
    "default_telemetry", "set_default_telemetry",
    "Tracer", "default_tracer", "set_default_tracer",
    "MetricsRegistry", "default_metrics", "set_default_metrics",
    "FaultEvent", "FaultInjector", "FaultPlan", "InjectedFault",
    "active_injector",
    "FaultTolerantLoop", "StragglerWatchdog", "elastic_remesh",
]
