"""Int8 serving quantization: QuantTensor weights and the precision
policy (port of ``repro.quant``)."""

from repro_torch.quant.policy import (DEFAULT_QUANT_KEYS, QuantPolicy,
                                      QuantTensor, choose_precision,
                                      quant_fraction, quantize_params,
                                      quantize_tensor, serving_quant_params)

__all__ = ["DEFAULT_QUANT_KEYS", "QuantPolicy", "QuantTensor",
           "choose_precision", "quant_fraction", "quantize_params",
           "quantize_tensor", "serving_quant_params"]
