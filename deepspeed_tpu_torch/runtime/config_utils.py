"""Config helpers (copy of deepspeed_tpu/runtime/config_utils.py: typed
dict access and duplicate-key JSON rejection)."""

import json


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while parsing JSON."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d


def load_config_dict(config):
    """Accept a path to a JSON file or an already-parsed dict."""
    if isinstance(config, dict):
        return config
    with open(config, "r") as f:
        return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
