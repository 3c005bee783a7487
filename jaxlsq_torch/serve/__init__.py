from .attention import decode_attention, decode_attention_plain
from . import custom_ops  # noqa: F401  (registers the serving operators)
from .convert import convert, serving_bits, shard_converted, shard_packed
from .decode import (DecodeEngine, Prefix, SpeculativeDecodeEngine, init_kv_cache,
                     make_beam_search, make_generate, make_sampler,
                     make_speculative_generate, prefill)
from .engine import ServingEngine
from .export import (export_generate, export_serving_forward, load_exported,
                     load_exported_file, save_exported_file)
from .matmul import (dynamic_int8_matmul, static_int8_conv, static_int8_matmul, wo_matmul,
                     wo_matmul_plain)
from .pack import (PackedWeight, dequantize_weight, pack_int4, quantize_weight,
                   quantize_weight_grouped, unpack_int4)
from .paged import (PageAllocator, PagedKVLayer, init_paged_cache,
                    paged_attention, paged_attention_plain, paged_update,
                    with_table)
from .paged_engine import PagedDecodeEngine, PagedPrefix, PagedSpeculativeDecodeEngine

__all__ = ["decode_attention", "decode_attention_plain", "convert", "serving_bits",
           "shard_packed", "shard_converted",
           "DecodeEngine", "Prefix", "SpeculativeDecodeEngine", "init_kv_cache",
           "make_beam_search", "make_generate", "make_sampler",
           "make_speculative_generate", "prefill", "ServingEngine", "wo_matmul",
           "wo_matmul_plain", "PackedWeight", "dequantize_weight", "pack_int4",
           "quantize_weight", "quantize_weight_grouped", "unpack_int4", "PageAllocator",
           "PagedKVLayer", "init_paged_cache", "paged_attention",
           "paged_attention_plain", "paged_update", "with_table",
           "PagedDecodeEngine", "PagedPrefix", "PagedSpeculativeDecodeEngine",
           "static_int8_matmul", "dynamic_int8_matmul", "static_int8_conv",
           "export_serving_forward", "export_generate", "load_exported",
           "save_exported_file", "load_exported_file"]
