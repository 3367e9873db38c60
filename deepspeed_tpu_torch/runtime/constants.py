"""Config keys and defaults (trimmed copy of
deepspeed_tpu/runtime/constants.py: the training keys the engine reads,
the `inference` block, the `moe` and `quantized_compute` blocks, the
`checkpoint`, `async_dispatch`, `autotune` and `overlap` blocks the
config validates, and the switches of the blocks
that later slices port). Values are identical to the JAX package's;
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
# 0 = dynamic loss scaling; any other value is a static scale
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

BFLOAT16 = "bf16"
BFLOAT16_ALIAS = "bfloat16"
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False
# master_weights=false drops the fp32 master copy AND fp32 Adam moments
# for bf16 state + stochastic-rounded updates (runtime/bf16_optimizer.py)
BFLOAT16_MASTER_WEIGHTS = "master_weights"
BFLOAT16_MASTER_WEIGHTS_DEFAULT = True
# Apex AMP, accepted for parity: "amp": {"enabled": true} maps to bf16
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

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
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001
PIPELINE = "pipeline"

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

# the blocks the port validates as the JAX package does and then, where
# it asks for something the port does not do yet, refuses
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = True
CHECKPOINT_KEEP_LAST = "keep_last"
CHECKPOINT_KEEP_LAST_DEFAULT = 0
CHECKPOINT_WRITER_QUEUE_DEPTH = "writer_queue_depth"
CHECKPOINT_WRITER_QUEUE_DEPTH_DEFAULT = 1
CHECKPOINT_QUEUE_POLICY = "queue_policy"
CHECKPOINT_QUEUE_POLICY_DEFAULT = "block"
CHECKPOINT_QUEUE_POLICIES = ["block", "drop"]

ASYNC_DISPATCH = "async_dispatch"
ASYNC_DISPATCH_ENABLED = "enabled"
ASYNC_DISPATCH_ENABLED_DEFAULT = True
ASYNC_DISPATCH_STEPS_PER_SYNC = "steps_per_sync"
ASYNC_DISPATCH_STEPS_PER_SYNC_DEFAULT = 0
ASYNC_DISPATCH_PREFETCH_DEPTH = "prefetch_depth"
ASYNC_DISPATCH_PREFETCH_DEPTH_DEFAULT = 2

AUTOTUNE = "autotune"
AUTOTUNE_ENABLED = "enabled"
AUTOTUNE_ENABLED_DEFAULT = True
AUTOTUNE_TABLE_PATH = "table_path"
AUTOTUNE_TABLE_PATH_DEFAULT = ""

OVERLAP = "overlap"
OVERLAP_ENABLED = "enabled"
OVERLAP_ENABLED_DEFAULT = True
OVERLAP_SITES = "sites"
OVERLAP_SITES_DEFAULT = "auto"
OVERLAP_ISSUE_DISTANCE = "issue_distance"
OVERLAP_ISSUE_DISTANCE_DEFAULT = 1

# zero_optimization.offload_wire: the ZeRO-Offload round trip's format
# (runtime/zero/offload.py). grad_bits (D2H): 32 native (bf16 when
# computing in bf16, else fp32), 16 bf16 always, 8 int8 with one fp32
# scale per 4096-element block, 1 sign bits + per-block scale with
# on-device error feedback. param_bits (H2D): 32 native, 8 an int8
# param delta against a device fp32 copy with a host shadow.
# warmup_steps: steps on an uncompressed fp32 wire before compression.
OFFLOAD_WIRE = "offload_wire"
OFFLOAD_WIRE_GRAD_BITS = "grad_bits"
OFFLOAD_WIRE_GRAD_BITS_DEFAULT = 32
OFFLOAD_WIRE_PARAM_BITS = "param_bits"
OFFLOAD_WIRE_PARAM_BITS_DEFAULT = 32
OFFLOAD_WIRE_WARMUP_STEPS = "warmup_steps"
OFFLOAD_WIRE_WARMUP_STEPS_DEFAULT = 0
OFFLOAD_WIRE_GRAD_BITS_VALID = (1, 8, 16, 32)
OFFLOAD_WIRE_PARAM_BITS_VALID = (8, 32)

#############################################
# Quantized compute (ops/transformer/quantized_matmul.py, kernel K6):
#   {"quantized_compute": {"enabled": true, "mode": "auto",
#                          "block": 128, "stochastic_rounding": false}}
# enabled: wire the family into the model at engine init (its
#   configure_quantized_compute hook; a model without it warns).
# mode: "auto" quantizes on CUDA only; "on" anywhere (the plain twin on
#   the CPU); "off" parks the block.
# block: quantization block along the contraction dim (a multiple of
#   128 on the kernel path).
# stochastic_rounding: round the int8 quantization stochastically from
#   the engine's per-step "quant" seed; with mode resolved off, the
#   bf16 operand casts round stochastically instead.
#############################################
QUANTIZED_COMPUTE = "quantized_compute"
QUANTIZED_COMPUTE_ENABLED = "enabled"
QUANTIZED_COMPUTE_ENABLED_DEFAULT = False
QUANTIZED_COMPUTE_MODE = "mode"
QUANTIZED_COMPUTE_MODE_DEFAULT = "auto"
QUANTIZED_COMPUTE_MODE_VALID = ("auto", "on", "off")
QUANTIZED_COMPUTE_BLOCK = "block"
QUANTIZED_COMPUTE_BLOCK_DEFAULT = 128
QUANTIZED_COMPUTE_STOCHASTIC_ROUNDING = "stochastic_rounding"
QUANTIZED_COMPUTE_STOCHASTIC_ROUNDING_DEFAULT = False

#############################################
# Mixture-of-experts (deepspeed_tpu_torch/moe/)
#############################################
MOE = "moe"
MOE_ENABLED = "enabled"
MOE_ENABLED_DEFAULT = False
MOE_NUM_EXPERTS = "num_experts"
MOE_NUM_EXPERTS_DEFAULT = 8
MOE_TOP_K = "top_k"
MOE_TOP_K_DEFAULT = 2
MOE_CAPACITY_FACTOR = "capacity_factor"
MOE_CAPACITY_FACTOR_DEFAULT = 1.25
MOE_AUX_LOSS_WEIGHT = "aux_loss_weight"
MOE_AUX_LOSS_WEIGHT_DEFAULT = 0.01
MOE_EVERY_N_LAYERS = "every_n_layers"
MOE_EVERY_N_LAYERS_DEFAULT = 1
MOE_JITTER_EPS = "jitter_eps"
MOE_JITTER_EPS_DEFAULT = 0.0
MOE_FUSED_DISPATCH = "fused_dispatch"
MOE_FUSED_DISPATCH_DEFAULT = "auto"
MOE_FUSED_DISPATCH_VALID = ("on", "off", "auto")

#############################################
# Mesh block: {"mesh": {"data": -1, "model": 1, "pipe": 1, "expert": 1}},
# -1 = infer from the device count; the `expert` axis exists only when
# the block names it. The port resolves it for its world size and runs
# no axis above 1 yet (runtime/config.py `resolve_mesh`).
#############################################
MESH = "mesh"
MESH_DATA_AXIS = "data"
MESH_MODEL_AXIS = "model"
MESH_PIPE_AXIS = "pipe"
MESH_EXPERT_AXIS = "expert"

#############################################
# Monitor block: unified async-safe telemetry — device-side metric
# accumulators drained at the async-dispatch sync fences, pluggable
# sinks (JSONL event log / native tfevents), step tracing, and a stall
# watchdog. See deepspeed_tpu_torch/monitor/.
#   {"monitor": {"enabled": true, "sinks": ["jsonl", "tensorboard"],
#                "output_path": "runs/x/monitor", "flush_interval": 0,
#                "stall_timeout_sec": 120, "stall_probe": false,
#                "all_ranks": false}}
#############################################
MONITOR = "monitor"
MONITOR_ENABLED = "enabled"
MONITOR_ENABLED_DEFAULT = False
MONITOR_SINKS = "sinks"
MONITOR_SINKS_DEFAULT = ("jsonl",)
MONITOR_OUTPUT_PATH = "output_path"
MONITOR_OUTPUT_PATH_DEFAULT = ""
MONITOR_JOB_NAME = "job_name"
MONITOR_JOB_NAME_DEFAULT = ""
MONITOR_FLUSH_INTERVAL = "flush_interval"
MONITOR_FLUSH_INTERVAL_DEFAULT = 0
MONITOR_STALL_TIMEOUT_SEC = "stall_timeout_sec"
MONITOR_STALL_TIMEOUT_SEC_DEFAULT = 0
MONITOR_STALL_PROBE = "stall_probe"
MONITOR_STALL_PROBE_DEFAULT = False
# Terminal stall verdict: after this many CONSECUTIVE watchdog fires
# with no intervening fence, emit one `stall_escalated` event (flight
# dump + sink event) and go quiet for the episode. 0 = off (one fire
# per stall episode, never terminal). A supervisor treats the
# escalated event as "stop waiting, recover from the last committed
# checkpoint".
MONITOR_STALL_ESCALATE_AFTER = "stall_escalate_after"
MONITOR_STALL_ESCALATE_AFTER_DEFAULT = 0
MONITOR_ALL_RANKS = "all_ranks"
MONITOR_ALL_RANKS_DEFAULT = False
# MFU denominator override (FLOP/s per chip). 0 = auto: the card's
# nominal dense bf16 peak on a known CUDA card, None (no MFU) on the CPU.
# Set it to make MFU / tokens_per_sec_per_chip meaningful on CPU
# rehearsal runs, or to report against a measured (rather than
# nominal) peak.
MONITOR_PEAK_FLOPS_OVERRIDE = "peak_flops_override"
MONITOR_PEAK_FLOPS_OVERRIDE_DEFAULT = 0.0

# -- monitor.trace: Perfetto/Chrome trace-event export ----------------
#   {"trace": {"enabled": true, "path": "", "max_events": 200000}}
# path defaults to <output_path>/trace_rank<r>.json; the file is
# written at monitor.close(), on a watchdog fire, and on demand via
# engine.monitor.export_trace(). `ds_trace merge` (monitor/trace_cli.py)
# merges per-rank shards.
MONITOR_TRACE = "trace"
MONITOR_TRACE_ENABLED = "enabled"
MONITOR_TRACE_ENABLED_DEFAULT = False
MONITOR_TRACE_PATH = "path"
MONITOR_TRACE_PATH_DEFAULT = ""
MONITOR_TRACE_MAX_EVENTS = "max_events"
MONITOR_TRACE_MAX_EVENTS_DEFAULT = 200000

# -- monitor.flight: crash/stall flight recorder ----------------------
#   {"flight": {"enabled": true, "capacity": 256, "path": ""}}
# A bounded in-memory ring of the last `capacity` monitor events +
# per-subsystem heartbeat ages, dumped atomically (tmp+fsync+rename)
# to flight_<ts>.json on watchdog fire, uncaught train_batch
# exception, SIGTERM, or abnormal interpreter exit. Enabled by default
# whenever the monitor is on (the ring is a deque append per event).
MONITOR_FLIGHT = "flight"
MONITOR_FLIGHT_ENABLED = "enabled"
MONITOR_FLIGHT_ENABLED_DEFAULT = True
MONITOR_FLIGHT_CAPACITY = "capacity"
MONITOR_FLIGHT_CAPACITY_DEFAULT = 256
MONITOR_FLIGHT_PATH = "path"
MONITOR_FLIGHT_PATH_DEFAULT = ""

# -- monitor.numerics: device-side numerics health --------------------
#   {"numerics": {"enabled": true}}
# Opt-in per-layer accumulators computed inside the step on the device
# (grad-norm/abs-max/nonfinite per top-level param group, activation
# abs-max/mean/nonfinite at layer boundaries for layer-exposing
# models) and drained in the existing one-copy-per-fence path —
# zero new per-step host syncs (guard-tested).
MONITOR_NUMERICS = "numerics"
MONITOR_NUMERICS_ENABLED = "enabled"
MONITOR_NUMERICS_ENABLED_DEFAULT = False

# -- monitor.memory: live HBM/host byte ledger ------------------------
#   {"memory": {"enabled": true, "top_buffers": 8}}
# ON by default with the monitor (like flight): every long-lived
# allocation site (engine state groups, offload host state, checkpoint
# snapshot double-buffers, prefetch staging, serving KV pools)
# registers its logical bytes from shape metadata; each fence
# reconciles ledger vs device_memory_stats + host RSS into a `memory`
# event (residual = activations and temporaries), tracks the peak
# watermark with the attribution snapshot AT peak, and renders
# Perfetto per-category counter tracks. Out-of-memory crashes
# (torch.OutOfMemoryError) get the ledger + top buffers + actionable
# hints attached to the flight dump. Zero new per-step host syncs (guard-tested).
MONITOR_MEMORY = "memory"
MONITOR_MEMORY_ENABLED = "enabled"
MONITOR_MEMORY_ENABLED_DEFAULT = True
MONITOR_MEMORY_TOP_BUFFERS = "top_buffers"
MONITOR_MEMORY_TOP_BUFFERS_DEFAULT = 8


# Elasticity (only the switch: elastic batch resolution is a later slice)
ELASTICITY = "elasticity"
ELASTICITY_ENABLED = "enabled"

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

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

SPARSE_MODE_VALID = (
    SPARSE_DENSE_MODE,
    SPARSE_FIXED_MODE,
    SPARSE_VARIABLE_MODE,
    SPARSE_BIGBIRD_MODE,
    SPARSE_BSLONGFORMER_MODE,
)
# the full sparse block surface: the block is passed through wholesale
# to the SparsityConfig constructors (ops/sparse_attention), so config
# parsing validates against this list instead of reading each key
SPARSE_ATTENTION_KEYS = (
    SPARSE_MODE,
    SPARSE_BLOCK,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
    SPARSE_NUM_LOCAL_BLOCKS,
    SPARSE_NUM_GLOBAL_BLOCKS,
    SPARSE_ATTENTION_TYPE,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
    SPARSE_NUM_RANDOM_BLOCKS,
    SPARSE_LOCAL_WINDOW_BLOCKS,
    SPARSE_GLOBAL_BLOCK_INDICES,
    SPARSE_GLOBAL_BLOCK_END_INDICES,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
)
