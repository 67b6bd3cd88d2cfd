"""Layers of the port (counterpart of paddle_tpu/nn/layer): `Layer` and
`ParamAttr`, the common (with the vision layers), conv, pooling, norm,
activation, loss, container and transformer layers. The rnn and extras
layers are not ported yet."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .layers import Layer, ParamAttr, Parameter  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
