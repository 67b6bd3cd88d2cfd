from .loss import cross_entropy  # noqa: F401
