"""Model side (counterpart of nvtabular_tpu/models/): DLRM, DeepFM, DCN-v2,
the tabular MLP and their training. Each model is an ``nn.Module`` with a
loss function ``*_loss(model, batch)`` that ``train_step`` and
``train_chunk`` take, and a reference forward through the kernels' plain
versions."""

from .deepfm import (
    DCN,
    CrossNetwork,
    DCNConfig,
    DeepFM,
    DeepFMConfig,
    dcn_loss,
    dcn_reference_forward,
    deepfm_loss,
    deepfm_reference_forward,
)
from .dlrm import (
    DLRM,
    DLRMConfig,
    batch_specs,
    dlrm_loss,
    dlrm_param_specs,
    make_synthetic_batch,
    reference_forward,
)
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

__all__ = [
    "Adagrad",
    "CrossNetwork",
    "DCN",
    "DCNConfig",
    "DLRM",
    "DLRMConfig",
    "DeepFM",
    "DeepFMConfig",
    "MLP",
    "TabularMLP",
    "TabularMLPConfig",
    "batch_specs",
    "bce_with_logits",
    "dcn_loss",
    "dcn_reference_forward",
    "deepfm_loss",
    "deepfm_reference_forward",
    "dlrm_loss",
    "dlrm_param_specs",
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
