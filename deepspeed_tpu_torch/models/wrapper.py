"""What the model entry points (`GPT2ForCausalLM`, `BertForPreTrainingLM`)
share: their `module`'s parameters as the flat {name: tensor} dict every
entry point takes, filled from a seed with the JAX model's per-leaf init,
or loaded from a dict (e.g. a converted JAX tree)."""

import torch

from deepspeed_tpu_torch.ops.transformer.transformer import init_params


class ModelWrapper:
    """A mixin over `self.module` (an nn.Module) and `self.device`."""

    def _init_params(self, seed, init_std):
        """Fill every parameter from `seed` (`ops.transformer.transformer
        .init_params`). Returns the parameter dict."""
        init_params(self.module, seed, init_std, self.device)
        return self.params()

    def params(self):
        """{name: tensor} views of the module's parameters."""
        return {name: p.detach()
                for name, p in self.module.named_parameters()}

    def load_params(self, params):
        """Copy a flat parameter dict (e.g. from models.convert) into the
        module."""
        own = dict(self.module.named_parameters())
        missing = set(own) - set(params)
        extra = set(params) - set(own)
        if missing or extra:
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(missing)[:5]}, extra "
                           f"{sorted(extra)[:5]}")
        with torch.no_grad():
            for name, p in own.items():
                src = torch.as_tensor(params[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} "
                                     f"!= {tuple(p.shape)}")
                p.copy_(src)
        return self.params()
