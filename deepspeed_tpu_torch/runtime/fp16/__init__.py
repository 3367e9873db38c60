"""fp16 mixed precision: the dynamic loss-scale automaton
(`loss_scaler.py`) and 1-bit Adam's single-worker form
(`onebit_adam.py`)."""
