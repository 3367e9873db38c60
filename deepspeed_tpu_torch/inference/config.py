"""`inference` config block parsing (copy of
deepspeed_tpu/inference/config.py: same keys, defaults and errors).

    {"inference": {"max_slots": 8,
                   "prefill_chunk": 64,
                   "sync_every": 8,
                   "max_new_tokens": 128,
                   "max_seq_len": null,
                   "eos_token_id": null,
                   "top_k_max": 64,
                   "seed": 0,
                   "weight_bits": 32,
                   "weight_quant_block": 64,
                   "observability": {"enabled": true,
                                     "slo_ttft_ms": 0,
                                     "slo_token_ms": 0},
                   "kv_cache": {"num_pages": 256, "page_size": 16},
                   "speculative": {"enabled": false,
                                   "draft_model": "truncate:1",
                                   "k": 4,
                                   "k_min": 1,
                                   "adaptive": true}}}

See the key-by-key commentary in the JAX package's runtime/constants.py
and docs/inference.md. This slice's engine raises NotImplementedError
for `weight_bits: 8` and an enabled `speculative` block. Validation
follows the monitor-config convention: every bad value raises with the
full dotted key name and the offending value.
"""

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param


class InferenceConfigError(Exception):
    pass


def _int(block, key, default, dotted):
    v = get_scalar_param(block, key, default)
    try:
        return int(v)
    except (TypeError, ValueError):
        raise InferenceConfigError(
            f"{dotted} must be an integer, got {v!r}")


def _pos_int(block, key, default, dotted, minimum=1):
    v = _int(block, key, default, dotted)
    if v < minimum:
        raise InferenceConfigError(
            f"{dotted} must be >= {minimum}, got {v}")
    return v


def _nonneg_float(block, key, default, dotted):
    v = get_scalar_param(block, key, default)
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise InferenceConfigError(
            f"{dotted} must be a number, got {v!r}")
    if v < 0:
        raise InferenceConfigError(
            f"{dotted} must be >= 0 (0 = no target), got {v}")
    return v


class InferenceConfig:
    """Parsed + validated `inference` block."""

    def __init__(self, param_dict=None):
        block = (param_dict or {}).get(C.INFERENCE, {})
        if not isinstance(block, dict):
            raise InferenceConfigError(
                f'"inference" must be a dict, got {block!r}')
        self.max_slots = _pos_int(
            block, C.INFERENCE_MAX_SLOTS, C.INFERENCE_MAX_SLOTS_DEFAULT,
            "inference.max_slots")
        self.prefill_chunk = _pos_int(
            block, C.INFERENCE_PREFILL_CHUNK,
            C.INFERENCE_PREFILL_CHUNK_DEFAULT, "inference.prefill_chunk")
        self.sync_every = _pos_int(
            block, C.INFERENCE_SYNC_EVERY, C.INFERENCE_SYNC_EVERY_DEFAULT,
            "inference.sync_every")
        self.max_new_tokens = _pos_int(
            block, C.INFERENCE_MAX_NEW_TOKENS,
            C.INFERENCE_MAX_NEW_TOKENS_DEFAULT,
            "inference.max_new_tokens")
        self.max_seq_len = get_scalar_param(
            block, C.INFERENCE_MAX_SEQ_LEN, C.INFERENCE_MAX_SEQ_LEN_DEFAULT)
        if self.max_seq_len is not None:
            self.max_seq_len = _pos_int(
                block, C.INFERENCE_MAX_SEQ_LEN, None,
                "inference.max_seq_len")
        self.eos_token_id = get_scalar_param(
            block, C.INFERENCE_EOS_TOKEN_ID,
            C.INFERENCE_EOS_TOKEN_ID_DEFAULT)
        if self.eos_token_id is not None:
            self.eos_token_id = _int(
                block, C.INFERENCE_EOS_TOKEN_ID, None,
                "inference.eos_token_id")
        self.top_k_max = _pos_int(
            block, C.INFERENCE_TOP_K_MAX, C.INFERENCE_TOP_K_MAX_DEFAULT,
            "inference.top_k_max")
        self.seed = _int(block, C.INFERENCE_SEED,
                         C.INFERENCE_SEED_DEFAULT, "inference.seed")
        self.weight_bits = _int(
            block, C.INFERENCE_WEIGHT_BITS,
            C.INFERENCE_WEIGHT_BITS_DEFAULT, "inference.weight_bits")
        if self.weight_bits not in C.INFERENCE_WEIGHT_BITS_VALID:
            raise InferenceConfigError(
                "inference.weight_bits must be one of "
                f"{C.INFERENCE_WEIGHT_BITS_VALID}, got {self.weight_bits}")
        self.weight_quant_block = _pos_int(
            block, C.INFERENCE_WEIGHT_QUANT_BLOCK,
            C.INFERENCE_WEIGHT_QUANT_BLOCK_DEFAULT,
            "inference.weight_quant_block")

        obs = block.get(C.INFERENCE_OBSERVABILITY, {})
        if not isinstance(obs, dict):
            raise InferenceConfigError(
                f'"inference.observability" must be a dict, got {obs!r}')
        self.observability_enabled = bool(get_scalar_param(
            obs, C.INFERENCE_OBS_ENABLED, C.INFERENCE_OBS_ENABLED_DEFAULT))
        self.slo_ttft_ms = _nonneg_float(
            obs, C.INFERENCE_OBS_SLO_TTFT_MS,
            C.INFERENCE_OBS_SLO_TTFT_MS_DEFAULT,
            "inference.observability.slo_ttft_ms")
        self.slo_token_ms = _nonneg_float(
            obs, C.INFERENCE_OBS_SLO_TOKEN_MS,
            C.INFERENCE_OBS_SLO_TOKEN_MS_DEFAULT,
            "inference.observability.slo_token_ms")

        kv = block.get(C.INFERENCE_KV_CACHE, {})
        if not isinstance(kv, dict):
            raise InferenceConfigError(
                f'"inference.kv_cache" must be a dict, got {kv!r}')
        # >= 2: page 0 is the reserved scratch page, so at least one
        # page must remain allocatable
        self.kv_num_pages = _pos_int(
            kv, C.INFERENCE_KV_NUM_PAGES, C.INFERENCE_KV_NUM_PAGES_DEFAULT,
            "inference.kv_cache.num_pages", minimum=2)
        self.kv_page_size = _pos_int(
            kv, C.INFERENCE_KV_PAGE_SIZE, C.INFERENCE_KV_PAGE_SIZE_DEFAULT,
            "inference.kv_cache.page_size")

        spec = block.get(C.INFERENCE_SPECULATIVE, {})
        if not isinstance(spec, dict):
            raise InferenceConfigError(
                f'"inference.speculative" must be a dict, got {spec!r}')
        self.spec_enabled = bool(get_scalar_param(
            spec, C.INFERENCE_SPEC_ENABLED,
            C.INFERENCE_SPEC_ENABLED_DEFAULT))
        self.spec_draft_model = get_scalar_param(
            spec, C.INFERENCE_SPEC_DRAFT_MODEL,
            C.INFERENCE_SPEC_DRAFT_MODEL_DEFAULT)
        if not isinstance(self.spec_draft_model, str) or not (
                self.spec_draft_model == "external" or
                self.spec_draft_model.startswith("truncate:")):
            raise InferenceConfigError(
                'inference.speculative.draft_model must be "truncate:N" '
                f'or "external", got {self.spec_draft_model!r}')
        if self.spec_draft_model.startswith("truncate:"):
            tail = self.spec_draft_model[len("truncate:"):]
            try:
                n = int(tail)
            except ValueError:
                n = 0
            if n < 1:
                raise InferenceConfigError(
                    "inference.speculative.draft_model truncate layer "
                    f"count must be a positive integer, got {tail!r}")
        self.spec_k = _pos_int(
            spec, C.INFERENCE_SPEC_K, C.INFERENCE_SPEC_K_DEFAULT,
            "inference.speculative.k")
        self.spec_k_min = _pos_int(
            spec, C.INFERENCE_SPEC_K_MIN, C.INFERENCE_SPEC_K_MIN_DEFAULT,
            "inference.speculative.k_min")
        if self.spec_k_min > self.spec_k:
            raise InferenceConfigError(
                f"inference.speculative.k_min ({self.spec_k_min}) must "
                f"be <= inference.speculative.k ({self.spec_k})")
        self.spec_adaptive = bool(get_scalar_param(
            spec, C.INFERENCE_SPEC_ADAPTIVE,
            C.INFERENCE_SPEC_ADAPTIVE_DEFAULT))
