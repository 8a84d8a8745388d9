"""repro_torch.ft — fault tolerance: failure detection, restart, elastic
re-mesh planning, straggler accounting.  The counterpart of
``repro.ft``."""
from .runtime import (ElasticPlan, FailureDetector, StragglerPolicy,
                      plan_elastic_remesh, run_with_restarts)

__all__ = ["FailureDetector", "StragglerPolicy", "ElasticPlan",
           "plan_elastic_remesh", "run_with_restarts"]
