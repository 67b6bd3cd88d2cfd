from .serving import (ContinuousBatchingEngine, GenerationRequest,  # noqa: F401
                      PagePool)
