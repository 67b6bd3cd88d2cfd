from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
