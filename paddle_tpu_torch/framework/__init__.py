from . import core  # noqa: F401
