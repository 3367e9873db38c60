"""Elasticity v0.1 — scheduling-time batch-size/device-count co-design
(port of deepspeed_tpu/elasticity/__init__.py: the same math, errors and
messages).

Pick the total batch size (a micro-batch or the micro-batch LCM, scaled
by the largest fitting highly-composite number) that maximizes the
number of compatible device counts; recovery = restart at the new count
and reload a checkpoint. The "device count" is the number of cards; the
math is identical. The runtime that acts on it is `elasticity/runtime.py`
(the supervisor), whose names this package re-exports lazily.
"""

import json
import math
import os
import re
from functools import reduce

ELASTICITY = "elasticity"
LATEST_ELASTICITY_VERSION = 0.1
ENABLED = "enabled"
ENABLED_DEFAULT = False
MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000
MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]
MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000
MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0
PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True
IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False
VERSION = "version"
VERSION_DEFAULT = LATEST_ELASTICITY_VERSION
MINIMUM_DEEPSPEED_VERSION = "0.3.8"
DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"

# Highly composite numbers — dense divisor structure means many compatible
# device counts per candidate batch size. Covers batch sizes to ~720K.
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260,
    1680, 2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360,
    50400, 55440, 83160, 110880, 166320, 221760, 277200, 332640, 498960,
    554400, 665280, 720720
]


class ElasticityError(Exception):
    """Base exception for elasticity errors."""


class ElasticityConfigError(ElasticityError):
    """Bad elasticity configuration."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """World size not in the valid device-count list."""


class ElasticityConfig:
    """Validated view of the "elasticity" config block (same keys as the
    reference; see module docstring)."""

    def __init__(self, param_dict):
        self.enabled = param_dict.get(ENABLED, ENABLED_DEFAULT)
        if self.enabled:
            for required in (MAX_ACCEPTABLE_BATCH_SIZE, MICRO_BATCHES):
                if required not in param_dict:
                    raise ElasticityConfigError(
                        f"Elasticity config missing {required}")
        self.max_acceptable_batch_size = param_dict.get(
            MAX_ACCEPTABLE_BATCH_SIZE, MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
        self.micro_batches = param_dict.get(MICRO_BATCHES,
                                            MICRO_BATCHES_DEFAULT)

        if not isinstance(self.micro_batches, list):
            raise ElasticityConfigError(
                f"{MICRO_BATCHES} must be a list, got "
                f"{type(self.micro_batches)}")
        if not all(isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"{MICRO_BATCHES} must be positive ints, got "
                f"{self.micro_batches}")

        self.min_gpus = param_dict.get(MIN_GPUS, MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(MAX_GPUS, MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < 1 or \
                self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"bad min/max device counts: {self.min_gpus}, {self.max_gpus}")
        self.min_time = param_dict.get(MIN_TIME, MIN_TIME_DEFAULT)
        if self.min_time < 0:
            raise ElasticityConfigError(f"min_time must be >= 0, "
                                        f"got {self.min_time}")
        self.version = param_dict.get(VERSION, VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(
            PREFER_LARGER_BATCH, PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            IGNORE_NON_ELASTIC_BATCH_INFO,
            IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4)


def _scale_to_hcn(base, ceiling):
    """base × largest HCN that keeps the product <= ceiling."""
    best = base
    for hcn in HCN_LIST:
        if base * hcn > ceiling:
            break
        best = base * hcn
    return best


def get_candidate_batch_sizes(base_list, max_acceptable_batch_size):
    return list({_scale_to_hcn(b, max_acceptable_batch_size)
                 for b in base_list})


def get_valid_gpus(batch_size, micro_batches, min_valid_gpus, max_valid_gpus):
    """All device counts g with min<=g<=max such that batch_size splits as
    g × k × m for some micro-batch m (g must divide batch_size/m)."""
    valid = set()
    for m in micro_batches:
        if batch_size % m != 0:
            continue
        q = batch_size // m
        for g in range(1, int(math.isqrt(q)) + 1):
            if q % g == 0:
                for cand in (g, q // g):
                    if min_valid_gpus <= cand <= max_valid_gpus:
                        valid.add(cand)
    return sorted(valid)


def get_best_candidates(candidate_batch_sizes, micro_batches, min_gpus,
                        max_gpus, prefer_larger):
    best_count, best_gpus, best_bs = 0, None, int(min(micro_batches))
    for bs in candidate_batch_sizes:
        gpus = get_valid_gpus(bs, micro_batches, min_gpus, max_gpus)
        better = len(gpus) > best_count or (
            len(gpus) == best_count and
            (bs > best_bs if prefer_larger else bs < best_bs))
        if better:
            best_count, best_gpus, best_bs = len(gpus), gpus, bs
    # No candidate admits any valid device count: return an empty list so
    # callers raise ElasticityIncompatibleWorldSize, not TypeError.
    return best_bs, best_gpus if best_gpus is not None else []


def _get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size,
                             min_gpus=None, max_gpus=None,
                             prefer_larger=True):
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    if not all(mb <= max_acceptable_batch_size for mb in micro_batches):
        raise ElasticityConfigError(
            "All micro batches must be <= max_acceptable_batch_size")
    lcm = reduce(math.lcm, micro_batches)
    bases = list(micro_batches) + [lcm]
    candidates = get_candidate_batch_sizes(bases, max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus,
                               prefer_larger)


def _parse_version(version_str):
    m = re.search(r"^(\d+)\.(\d+)(?:\.(\d+))?", version_str)
    if m is None:
        raise ElasticityError(f"cannot parse version {version_str}")
    return int(m.group(1)), int(m.group(2)), int(m.group(3) or 0)


def _compatible_ds_version_check(target_version: str):
    if _parse_version(target_version) < _parse_version(
            MINIMUM_DEEPSPEED_VERSION):
        raise ElasticityError(
            f"Target version {target_version} < minimum "
            f"{MINIMUM_DEEPSPEED_VERSION} supporting elasticity")
    return True


def elasticity_enabled(ds_config: dict):
    return ds_config.get(ELASTICITY, {}).get(ENABLED, ENABLED_DEFAULT)


def ensure_immutable_elastic_config(runtime_elastic_config_dict: dict):
    """Assert the scheduler and runtime saw the same elastic config."""
    from deepspeed_tpu_torch.utils.logging import logger
    if DEEPSPEED_ELASTICITY_CONFIG not in os.environ:
        logger.warning(
            f"{DEEPSPEED_ELASTICITY_CONFIG} env not set; cannot guarantee "
            "the resource scheduler will use compatible device counts")
        return
    sched = ElasticityConfig(
        json.loads(os.environ[DEEPSPEED_ELASTICITY_CONFIG]))
    runtime = ElasticityConfig(runtime_elastic_config_dict)
    for field in ("max_acceptable_batch_size", "micro_batches", "version"):
        if getattr(runtime, field) != getattr(sched, field):
            raise ElasticityConfigError(
                f"Elastic config '{field}' mismatch: scheduler saw "
                f"{getattr(sched, field)}, runtime has "
                f"{getattr(runtime, field)}")


def __getattr__(name):
    # Lazy re-export of the elastic runtime (elasticity/runtime.py):
    # this package is imported by config parsing, which must not pull
    # in the engine.
    if name in ("ElasticSupervisor", "FaultInjector", "FaultEvent",
                "BatchSpec", "ElasticRuntimeConfig",
                "LossContinuityError", "classify_failure"):
        from deepspeed_tpu_torch.elasticity import runtime as _rt
        return getattr(_rt, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def compute_elastic_config(ds_config: dict, target_deepspeed_version: str,
                           world_size=0):
    """Compute (final_batch_size, valid_gpus[, micro_batch_size]).

    Same contract as the reference API: deterministic for a given config;
    when world_size > 0, also picks the largest compatible micro-batch.
    """
    if not isinstance(ds_config, dict):
        raise ValueError(f"Expected dict config, got {type(ds_config)}")
    if ELASTICITY not in ds_config:
        raise ElasticityConfigError(f"'{ELASTICITY}' missing from config")
    block = ds_config[ELASTICITY]
    if not block.get(ENABLED, ENABLED_DEFAULT):
        raise ElasticityConfigError("Elasticity is disabled")
    cfg = ElasticityConfig(block)
    if float(cfg.version) > LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"elasticity version {cfg.version} > supported "
            f"{LATEST_ELASTICITY_VERSION}")
    _compatible_ds_version_check(target_deepspeed_version)

    if float(cfg.version) != 0.1:
        raise NotImplementedError(
            f"no elastic logic for version {cfg.version}")
    final_batch_size, valid_gpus = _get_compatible_gpus_v01(
        micro_batches=cfg.micro_batches,
        max_acceptable_batch_size=cfg.max_acceptable_batch_size,
        min_gpus=cfg.min_gpus, max_gpus=cfg.max_gpus,
        prefer_larger=cfg.prefer_larger_batch_size)
    final_batch_size = int(final_batch_size)

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"World size ({world_size}) not in valid counts: "
                f"{valid_gpus}")
        micro = next((m for m in sorted(set(cfg.micro_batches), reverse=True)
                      if (final_batch_size // world_size) % m == 0), None)
        assert micro is not None, (
            f"No divisible micro batch: world_size={world_size}, "
            f"final_batch_size={final_batch_size}, "
            f"micro_batches={cfg.micro_batches}")
        return final_batch_size, valid_gpus, micro

    return final_batch_size, valid_gpus
