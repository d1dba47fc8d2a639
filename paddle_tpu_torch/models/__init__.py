"""Model families of the port."""
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama2_7b,
                    tiny_llama_config, tiny_moe_llama_config)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama2_7b",
           "tiny_llama_config", "tiny_moe_llama_config"]
