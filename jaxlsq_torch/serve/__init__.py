from .attention import decode_attention, decode_attention_plain
from .convert import convert, serving_bits
from .decode import DecodeEngine, init_kv_cache, make_generate, make_sampler, prefill
from .matmul import wo_matmul, wo_matmul_plain
from .pack import (PackedWeight, dequantize_weight, pack_int4, quantize_weight,
                   unpack_int4)

__all__ = ["decode_attention", "decode_attention_plain", "convert", "serving_bits",
           "DecodeEngine", "init_kv_cache", "make_generate", "make_sampler",
           "prefill", "wo_matmul", "wo_matmul_plain", "PackedWeight",
           "dequantize_weight", "pack_int4", "quantize_weight", "unpack_int4"]
