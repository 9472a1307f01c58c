"""fluid.layers for the port: the functions programs are built from
(counterpart of paddle_tpu/layers/__init__.py, in its order): nn,
tensor, loss, control_flow, sequence_lod, detection, rnn and the static
LR schedules, with the reference's call signatures."""
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .loss import *        # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .detection import *   # noqa: F401,F403
from . import detection    # noqa: F401
from .rnn import *      # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import learning_rate_scheduler  # noqa: F401
