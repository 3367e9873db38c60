"""Config keys and defaults (trimmed copy of
deepspeed_tpu/runtime/constants.py: the training keys the engine reads,
the `inference` block, and the switches of the blocks that later slices
port). Values are identical to the JAX package's;
tests/test_torch_inference.py and tests/test_torch_engine.py hold them
equal."""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and lr scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    LAMB_OPTIMIZER,
    ONEBIT_ADAM_OPTIMIZER,
    SGD_OPTIMIZER,
]

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_ALIAS = "bfloat16"
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False
# master_weights=false drops the fp32 master copy AND fp32 Adam moments
# for bf16 state + stochastic-rounded updates (runtime/bf16_optimizer.py)
BFLOAT16_MASTER_WEIGHTS = "master_weights"
BFLOAT16_MASTER_WEIGHTS_DEFAULT = True

#############################################
# Gradient handling
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# Logging
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

#############################################
# Blocks of later slices (the switches only)
#############################################
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PIPELINE = "pipeline"
MOE = "moe"
QUANTIZED_COMPUTE = "quantized_compute"

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
