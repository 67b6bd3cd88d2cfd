"""Neural-network functionals and layers of the port (counterpart of
paddle_tpu/nn): the ported layers at the top level, as the reference
exports them, the gradient clips (`nn.clip`), and `nn.functional`."""
from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                    Dropout3D, LayerNorm, Linear, MultiHeadAttention)
