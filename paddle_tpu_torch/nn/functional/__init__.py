"""Neural-network functionals of the port (counterpart of
paddle_tpu/nn/functional)."""
from .attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention, sdp_kernel)
from .common import (alpha_dropout, dropout, dropout2d,  # noqa: F401
                     dropout3d, feature_alpha_dropout)
from .loss import cross_entropy  # noqa: F401
