"""Resident fleet service: continuous batching for simulation-as-a-service
(the port of ``librabft_simulator_tpu/serve``).

* :mod:`.scenario`: the per-slot scenario plane, the knobs of a run as
  per-instance rows, so one fleet serves heterogeneous scenarios.
* :mod:`.service`: :class:`ResidentFleet`, the never-exiting chunk loop
  with an admission queue (scenarios install into halted slots between
  chunks) and per-request result egress.
* :mod:`.api`: :class:`FleetService`, submit/poll/drain as a library and
  the NDJSON request reader; :mod:`.cli` is its command-line front end.
"""

from .scenario import ScenarioPlane, ScenarioSpec  # noqa: F401
from .service import ResidentFleet, ScenarioRequest  # noqa: F401
from .api import FleetService, load_requests  # noqa: F401
