"""fluid.layers for the port: the functions the BERT and GPT programs and
the static LR schedules are built from (counterpart of
paddle_tpu/layers/{nn,tensor,loss,learning_rate_scheduler}.py). Same call
signatures as the reference for this subset; the rest of the layers API is
not ported yet (ROADMAP)."""
from .loss import *        # noqa: F401,F403
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import learning_rate_scheduler  # noqa: F401
