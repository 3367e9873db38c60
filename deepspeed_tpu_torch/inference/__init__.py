"""deepspeed_tpu_torch.inference — the serving engine (port of
deepspeed_tpu.inference).

  * InferenceEngine (engine.py): chunked prefill + single-token decode
    steps, device-side sampling, no per-token host sync.
  * PagedKVCache (kv_cache.py): fixed-size pages in one preallocated
    device pool, per-request page tables, host-side alloc/free at
    serving fences.
  * ServingLoop / Request / serve_sequential (scheduler.py):
    iteration-level continuous batching with chunked prefill
    interleaving and EOS/max-tokens eviction.
  * InferenceConfig (config.py): the `inference` config block.
  * int8 weight-only quantization (quant.py): per-block-scale
    kernels quantized once at load, dequant-in-matmul epilogue.
  * speculative decoding (speculative.py): draft-model propose,
    batched flagship verify, lossless acceptance on the device.
"""

from deepspeed_tpu_torch.inference.config import (InferenceConfig,
                                                  InferenceConfigError)
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache
from deepspeed_tpu_torch.inference.scheduler import (Request, ServingLoop,
                                                     serve_sequential)

__all__ = [
    "InferenceEngine", "PagedKVCache", "ServingLoop", "Request",
    "serve_sequential", "InferenceConfig", "InferenceConfigError",
]
