"""fluid.layers for the port: the functions the BERT pretrain program is
built from (counterpart of paddle_tpu/layers/{nn,tensor,loss}.py). Same
call signatures as the reference for this subset; the rest of the layers
API is not ported yet (ROADMAP)."""
from .loss import *        # noqa: F401,F403
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
