"""Model families of the port."""
from .bert import (BertConfig, BertForMaskedLM, BertModel,
                   BertPretrainingCriterion)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_medium,
                  gpt2_small, gpt3_6p7b)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama2_7b,
                    tiny_llama_config, tiny_moe_llama_config)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama2_7b",
           "tiny_llama_config", "tiny_moe_llama_config", "GPTConfig",
           "GPTModel", "GPTForCausalLM", "gpt2_small", "gpt2_medium",
           "gpt3_6p7b", "BertConfig", "BertModel", "BertForMaskedLM",
           "BertPretrainingCriterion"]
