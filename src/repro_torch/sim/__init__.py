"""Mirrors ``src/repro/sim/__init__.py`` verbatim (own copy).

repro.sim — discrete-event cluster simulator driving the real cache
policy code with modeled time (the quantitative vehicle for the paper's
Figs. 3 and 5–7 on a single CPU container)."""
from .cluster import ClusterSim, HardwareModel, SimResult
from .workloads import (bursty_arrivals, coalesce_job, diurnal_arrivals,
                        multi_tenant_zip, poisson_arrivals,
                        zip_access_trace, zip_job)

__all__ = ["ClusterSim", "HardwareModel", "SimResult", "coalesce_job",
           "multi_tenant_zip", "zip_access_trace", "zip_job",
           "poisson_arrivals", "bursty_arrivals", "diurnal_arrivals"]
