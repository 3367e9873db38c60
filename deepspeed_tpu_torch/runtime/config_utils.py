"""Config helpers (trimmed copy of deepspeed_tpu/runtime/config_utils.py:
only what the inference config parser uses)."""


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)
