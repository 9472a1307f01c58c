"""Observability of the port: the typed metrics registry, the host tracer
(spans, instants, flows, chrome-trace export), the flight recorder and
the pod-scope merge of a gang's flight dumps (counterparts of
paddle_tpu/observability/{metrics,trace,flight,podscope}.py)."""
from . import metrics  # noqa: F401
from . import trace  # noqa: F401
from . import flight  # noqa: F401
from . import podscope  # noqa: F401
from .trace import RecordEvent  # noqa: F401
