"""fluid.contrib for the port (counterpart of paddle_tpu/contrib): the
contrib layers over the dense tail's CTR and vision ops. The reference's
`contrib.slim` (quantization) waits for its int8 ops (ROADMAP item 12,
row 7)."""
from . import layers  # noqa: F401
