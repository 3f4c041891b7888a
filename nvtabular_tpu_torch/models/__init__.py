"""Model side (counterpart of nvtabular_tpu/models/): DLRM, the tabular MLP
and their training.

DeepFM and DCN-v2 are not ported yet (ROADMAP.md queue 1 item 9); their
entry points raise.
"""

from .dlrm import DLRM, DLRMConfig, dlrm_loss, make_synthetic_batch, reference_forward
from .layers import (
    MLP,
    bce_with_logits,
    dot_product_interaction,
    embedding_lookup,
    multihot_embedding_lookup,
    xdeepfm_outer_product,
)
from .tabular_mlp import TabularMLP, TabularMLPConfig, tabular_mlp_loss, tabular_reference_forward
from .training import Adagrad, process_epoch, roc_auc, train_chunk, train_step


def _not_ported(*args, **kwargs):
    raise NotImplementedError("DeepFM and DCN-v2 are not ported yet (ROADMAP.md queue 1 item 9)")


deepfm_init = deepfm_forward = dcn_init = dcn_forward = _not_ported

__all__ = [
    "Adagrad",
    "DLRM",
    "DLRMConfig",
    "MLP",
    "TabularMLP",
    "TabularMLPConfig",
    "bce_with_logits",
    "dcn_forward",
    "dcn_init",
    "deepfm_forward",
    "deepfm_init",
    "dlrm_loss",
    "dot_product_interaction",
    "embedding_lookup",
    "make_synthetic_batch",
    "multihot_embedding_lookup",
    "process_epoch",
    "reference_forward",
    "roc_auc",
    "tabular_mlp_loss",
    "tabular_reference_forward",
    "train_chunk",
    "train_step",
    "xdeepfm_outer_product",
]
