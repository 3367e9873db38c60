"""Model-surgery helpers for sparse attention (port of
deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py; ref
`sparse_attention_utils.py:13-225`): pad sequences to a block multiple,
extend position embeddings for longer contexts."""

import numpy as np
import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    @staticmethod
    def extend_position_embedding(pos_embedding, max_position):
        """Tile an existing [old_max, H] position embedding out to
        max_position rows (ref `:34-76` repeats the learned table)."""
        table = torch.as_tensor(np.asarray(pos_embedding)) \
            if not isinstance(pos_embedding, torch.Tensor) else pos_embedding
        old_max = table.shape[0]
        if max_position <= old_max:
            raise ValueError("new max_position must exceed the original")
        reps = -(-max_position // old_max)
        return table.repeat(reps, 1)[:max_position]

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Right-pad sequence tensors to a multiple of block_size
        (ref `:156-225`). Returns (pad_len, *padded tensors in the same
        order). `model_embeddings` embeds the pad ids for
        `inputs_embeds`: an embedding module (called) or table (indexed);
        without it the padded embeddings are zeros."""
        ref = input_ids if input_ids is not None else inputs_embeds
        seq_len = ref.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size

        def pad_tokens(x, value=0):
            if x is None or pad_len == 0:
                return x
            x = torch.as_tensor(x)
            widths = [0, 0] * (x.ndim - 2) + [0, pad_len]
            return F.pad(x, widths, value=value)

        input_ids = pad_tokens(input_ids, pad_token_id)
        attention_mask = pad_tokens(attention_mask, 0)
        token_type_ids = pad_tokens(token_type_ids, 0)
        position_ids = pad_tokens(position_ids, 0)
        if inputs_embeds is not None and pad_len > 0:
            if model_embeddings is not None:
                pad_ids = torch.full((inputs_embeds.shape[0], pad_len),
                                     pad_token_id, dtype=torch.long,
                                     device=inputs_embeds.device)
                pad_embeds = model_embeddings(pad_ids) \
                    if callable(model_embeddings) \
                    else model_embeddings[pad_ids]
            else:
                pad_embeds = torch.zeros(
                    (inputs_embeds.shape[0], pad_len,
                     inputs_embeds.shape[2]), dtype=inputs_embeds.dtype,
                    device=inputs_embeds.device)
            inputs_embeds = torch.cat(
                [inputs_embeds, pad_embeds.to(inputs_embeds.dtype)], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Drop the padding rows added by pad_to_block_size (ref `:227`)."""
        if pad_len > 0:
            return sequence_output[:, :-pad_len]
        return sequence_output
