"""Model zoo of the port: the dense GQA and MoE families (counterpart of
``repro.models``; the SSM, hybrid and encoder-decoder families wait)."""

from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state, init_params,
                                            lm_loss, model_schema, prefill)

__all__ = ["model_schema", "init_params", "forward", "lm_loss",
           "init_decode_state", "decode_step", "prefill"]
