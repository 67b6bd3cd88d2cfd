"""Neural-network functionals and layers of the port (counterpart of
paddle_tpu/nn): `Layer`, `ParamAttr`, the initializers
(`nn.initializer`), the ported layers at the top level as the reference
exports them (common with the vision layers, conv, pooling, norm,
activation, loss, container, transformer), beam search
(`BeamSearchDecoder`, `dynamic_decode`), the gradient clips (`nn.clip`),
and `nn.functional`. The rnn and extras layers are not ported yet."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403

