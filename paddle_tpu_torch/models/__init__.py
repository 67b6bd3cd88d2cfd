from .llama import (LlamaConfig, LlamaForCausalLM, llama_1b,  # noqa: F401
                    llama_350m, llama_7b, llama_tiny)
