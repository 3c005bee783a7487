"""jaxlsq_torch.native: host C++ components (port of ``jaxlsq/native``).

Built with ``g++`` at first use into ``jaxlsq_torch/_build/`` and loaded
through ctypes; the port keeps its own copies of the sources:

* ``lsq_ref.cpp``: an independent implementation of the numeric contract,
  an oracle for the golden functions and the card's fake-quant kernels
  (``native_forward``/``native_backward``/``native_quantize_i8``, numpy in
  and out);
* ``loader.cpp``: the multi-threaded prefetching shard loader
  (``NativeShardLoader``: memory-mapped ``.npy`` shards, a shuffled batch
  ring deterministic per seed, torch tensors out).
"""

from .build import is_available, load_library
from .loader import NativeShardLoader
from .ops import native_backward, native_forward, native_quantize_i8

__all__ = ["is_available", "load_library", "native_forward", "native_backward",
           "native_quantize_i8", "NativeShardLoader"]
