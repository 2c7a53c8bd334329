"""Resilience layer: fault policies + deterministic chaos injection.

Port of nnstreamer_tpu/resilience/. ``policy`` owns the react-side
primitives (RetryPolicy, RetryBudget, CircuitBreaker, Deadline,
shed/fallback/hedge accounting); ``chaos`` owns the seeded
fault-injection harness that makes those policies testable. Import the
submodules directly — ``chaos`` is intentionally NOT pulled in here so
merely importing a policy user (e.g. the query client) never touches the
wire/graph hook modules.
"""

from . import policy  # noqa: F401  (the package's stable surface)
