"""Model zoo of the port: the dense GQA, MoE, Mamba-2 SSD, hybrid and
encoder-decoder families (counterpart of ``repro.models``)."""

from repro_torch.models import ssm
from repro_torch.models.transformer import (decode_step, encode, forward,
                                            init_decode_state, init_params,
                                            lm_loss, model_schema, prefill)

__all__ = ["model_schema", "init_params", "forward", "lm_loss",
           "init_decode_state", "decode_step", "encode", "prefill", "ssm"]
