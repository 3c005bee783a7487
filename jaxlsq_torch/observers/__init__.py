from .quantizer import LSQQuantizer, convert_shift_to_zp

__all__ = ["LSQQuantizer", "convert_shift_to_zp"]
