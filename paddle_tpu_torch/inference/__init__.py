from .serving import (ContinuousBatchingEngine, GenerationRequest,  # noqa: F401
                      PagePool, quantize_state_int8)
