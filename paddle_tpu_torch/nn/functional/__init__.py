"""Neural-network functionals of the port (counterpart of
paddle_tpu/nn/functional)."""
from .attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention, sdp_kernel)
from .loss import cross_entropy  # noqa: F401
