"""Progressive layer drop (port of
deepspeed_tpu/runtime/progressive_layer_drop.py; parity with
`deepspeed/runtime/progressive_layer_drop.py:5`).

Keep-probability schedule theta(t) = (1 - theta) * exp(-gamma * t) +
theta. The engine updates it from its host step count each step and
hands the current theta to the model as a 0-dim device tensor
(`layer_keep_prob`); GPT-2 gates each block's output on it
(`models/gpt2.py`).
"""

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        logger.info(f"Enabled progressive layer dropping (theta = "
                    f"{self.theta})")

    def get_state(self):
        return {"progressive_layer_drop": True,
                "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1. - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
