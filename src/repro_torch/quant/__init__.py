from repro_torch.quant.quantize import (BlockedPack, PackedLinear, QuantParams,
                                       build_blocked_layout, calibrate_minmax,
                                       calibrate_tensor, concat_packs,
                                       pack_linear, quantize, quantize_i32,
                                       quantized_linear)

__all__ = ["BlockedPack", "PackedLinear", "QuantParams",
           "build_blocked_layout", "calibrate_minmax", "calibrate_tensor",
           "concat_packs", "pack_linear", "quantize", "quantize_i32",
           "quantized_linear"]
