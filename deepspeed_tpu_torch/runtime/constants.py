"""Config keys and defaults (trimmed copy of
deepspeed_tpu/runtime/constants.py: the `inference` block, and the
`monitor` switch the serving engine checks). Values are identical to
the JAX package's; tests/test_torch_inference.py holds them equal."""

#############################################
# Monitor (only the switch: the monitor itself is a later slice)
#############################################
MONITOR = "monitor"
MONITOR_ENABLED = "enabled"
MONITOR_ENABLED_DEFAULT = False

#############################################
# Inference/serving engine
#############################################
INFERENCE = "inference"
INFERENCE_MAX_SLOTS = "max_slots"
INFERENCE_MAX_SLOTS_DEFAULT = 8
INFERENCE_PREFILL_CHUNK = "prefill_chunk"
INFERENCE_PREFILL_CHUNK_DEFAULT = 64
INFERENCE_SYNC_EVERY = "sync_every"
INFERENCE_SYNC_EVERY_DEFAULT = 8
INFERENCE_MAX_NEW_TOKENS = "max_new_tokens"
INFERENCE_MAX_NEW_TOKENS_DEFAULT = 128
INFERENCE_MAX_SEQ_LEN = "max_seq_len"
INFERENCE_MAX_SEQ_LEN_DEFAULT = None
INFERENCE_EOS_TOKEN_ID = "eos_token_id"
INFERENCE_EOS_TOKEN_ID_DEFAULT = None
INFERENCE_TOP_K_MAX = "top_k_max"
INFERENCE_TOP_K_MAX_DEFAULT = 64
INFERENCE_SEED = "seed"
INFERENCE_SEED_DEFAULT = 0
INFERENCE_WEIGHT_BITS = "weight_bits"
INFERENCE_WEIGHT_BITS_DEFAULT = 32
INFERENCE_WEIGHT_BITS_VALID = (8, 32)
INFERENCE_WEIGHT_QUANT_BLOCK = "weight_quant_block"
INFERENCE_WEIGHT_QUANT_BLOCK_DEFAULT = 64
INFERENCE_KV_CACHE = "kv_cache"
INFERENCE_KV_NUM_PAGES = "num_pages"
INFERENCE_KV_NUM_PAGES_DEFAULT = 256
INFERENCE_KV_PAGE_SIZE = "page_size"
INFERENCE_KV_PAGE_SIZE_DEFAULT = 16
INFERENCE_OBSERVABILITY = "observability"
INFERENCE_OBS_ENABLED = "enabled"
INFERENCE_OBS_ENABLED_DEFAULT = True
INFERENCE_OBS_SLO_TTFT_MS = "slo_ttft_ms"
INFERENCE_OBS_SLO_TTFT_MS_DEFAULT = 0.0
INFERENCE_OBS_SLO_TOKEN_MS = "slo_token_ms"
INFERENCE_OBS_SLO_TOKEN_MS_DEFAULT = 0.0
INFERENCE_SPECULATIVE = "speculative"
INFERENCE_SPEC_ENABLED = "enabled"
INFERENCE_SPEC_ENABLED_DEFAULT = False
INFERENCE_SPEC_DRAFT_MODEL = "draft_model"
INFERENCE_SPEC_DRAFT_MODEL_DEFAULT = "truncate:1"
INFERENCE_SPEC_K = "k"
INFERENCE_SPEC_K_DEFAULT = 4
INFERENCE_SPEC_K_MIN = "k_min"
INFERENCE_SPEC_K_MIN_DEFAULT = 1
INFERENCE_SPEC_ADAPTIVE = "adaptive"
INFERENCE_SPEC_ADAPTIVE_DEFAULT = True
