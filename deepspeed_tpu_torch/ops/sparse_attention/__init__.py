"""Block-sparse attention (port of deepspeed_tpu/ops/sparse_attention):
the layout configs, the block-sparse flash attention on kernels K7, the
SparseSelfAttention / BertSparseSelfAttention modules, the model-surgery
utils and the standalone MatMul / Softmax primitives."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
    VariableSparsityConfig, BigBirdSparsityConfig,
    BSLongformerSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    block_sparse_attention, layout_to_dense_mask)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, BertSparseSelfAttention)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    SparseAttentionUtils)
from deepspeed_tpu_torch.ops.sparse_attention.matmul import (MatMul, to_sparse,
                                                             to_dense)
from deepspeed_tpu_torch.ops.sparse_attention.softmax import Softmax

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "block_sparse_attention",
    "layout_to_dense_mask", "SparseSelfAttention",
    "BertSparseSelfAttention", "SparseAttentionUtils",
    "MatMul", "Softmax", "to_sparse", "to_dense",
]
