"""fluid.layers for the port: the functions programs are built from
(counterpart of paddle_tpu/layers/__init__.py, in its order):
nn, tensor, loss, control_flow, sequence_lod, rnn and the static LR
schedules. Same call signatures as the reference for this subset; the
rest of the layers API (detection) is not ported yet (ROADMAP)."""
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .loss import *        # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .rnn import *      # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import learning_rate_scheduler  # noqa: F401
