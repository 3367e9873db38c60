from deepspeed_tpu_torch.module_inject.replace_module import (
    replace_transformer_layer, revert_transformer_layer, replace_module,
    convert_bert_layer_params, revert_bert_layer_params)

__all__ = ["replace_transformer_layer", "revert_transformer_layer",
           "replace_module", "convert_bert_layer_params",
           "revert_bert_layer_params"]
