"""Resilience layer — port of nnstreamer_tpu/resilience/, the deadline
section only (``policy``): ``Deadline`` and the shed accounting the
device engine (sched/) rides. Retry policies, budgets, circuit breakers
and the chaos harness wait for the query layer (ROADMAP §A8)."""

from . import policy  # noqa: F401  (the package's stable surface)
