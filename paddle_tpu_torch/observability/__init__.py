"""Observability of the port: the typed metrics registry, the host tracer
(spans, instants, flows, chrome-trace export) and the flight recorder
(counterparts of paddle_tpu/observability/{metrics,trace,flight}.py;
podscope.py is not ported)."""
from . import metrics  # noqa: F401
from . import trace  # noqa: F401
from . import flight  # noqa: F401
from .trace import RecordEvent  # noqa: F401
