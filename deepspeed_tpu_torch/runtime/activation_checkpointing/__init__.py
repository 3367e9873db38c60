"""User-facing activation checkpointing (port of
deepspeed_tpu/runtime/activation_checkpointing/)."""
