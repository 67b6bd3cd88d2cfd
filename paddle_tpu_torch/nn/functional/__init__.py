"""Neural-network functionals of the port (counterpart of
paddle_tpu/nn/functional): activations, the common functionals and
dropouts, norms, losses, attention, and `gather_tree`. The conv,
pooling and vision functionals (and `pad`, `sequence_mask`,
`temporal_shift`) are not ported yet."""
from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from ..decode import gather_tree  # noqa: F401,E402
