from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.kernels.quantize.quantize import QBLOCK

__all__ = ["quantize", "dequantize", "QBLOCK"]
