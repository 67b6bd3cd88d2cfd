"""Vision (counterpart of paddle_tpu/vision): `vision.models`' ResNet
family. `vision.ops`, `transforms` and `datasets` are not ported yet
(ROADMAP Queue 1 item 11)."""
from . import models  # noqa: F401
