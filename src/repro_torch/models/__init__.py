"""LM substrate of the port (counterpart of ``repro.models``)."""
from repro_torch.models.model import (active_param_count, apply_model,
                                      decode_step, frontend_input,
                                      init_cache, init_model, next_token,
                                      pad_cache_to, param_count, prefill)

__all__ = ["active_param_count", "apply_model", "decode_step",
           "frontend_input", "init_cache", "init_model", "next_token",
           "pad_cache_to", "param_count", "prefill"]
