"""Neural-network functionals of the port (counterpart of
paddle_tpu/nn/functional): activations, the common functionals and
dropouts, the image functionals (`interpolate`, the shuffles, `unfold` /
`fold`), conv, pooling, `affine_grid` / `grid_sample`, `pad`, norms,
losses, attention, and `gather_tree`. `sequence_mask` and
`temporal_shift` are not ported yet."""
from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403
from ..decode import gather_tree  # noqa: F401,E402
from ...ops.manipulation import pad  # noqa: F401,E402
