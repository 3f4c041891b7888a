"""Training helpers: the counterpart of ``nvtabular_tpu/models/training.py``.

``Adagrad`` follows optax's ``adagrad`` (``scale_by_rss`` then the learning
rate), not ``torch.optim.Adagrad``: the accumulator starts at 0.1 rather
than 0, and eps sits inside the square root. ``train_step`` and ``train_chunk`` stand in for
``make_step_fns`` and ``make_chunk_train_fn``; ``train_chunk`` is a Python
loop over the chunk's batches that leaves every loss on the device (no host
sync per step). Each takes the loss function, ``loss_fn(model, batch)``, as
``make_step_fns(loss_fn, optimizer)`` does (``dlrm_loss`` by default).
``process_epoch`` and ``roc_auc`` are copies.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..kernels.adagrad import adagrad_update
from .dlrm import dlrm_loss


INITIAL_ACCUMULATOR = 0.1  # optax.adagrad's default


class Adagrad:
    """optax.adagrad(lr) over ``params``: the accumulator starts at
    INITIAL_ACCUMULATOR, then each step

        acc = g * g + acc
        update = -lr * g * (rsqrt(acc + EPS) where acc > 0 else 0)

    ``step`` is one fused pass over every parameter with a gradient
    (``kernels.adagrad.adagrad_update``: kernel K18 on the card, one launch
    for up to 64 tensors; the plain version on the CPU). The gradient is
    dense, as optax's, and read in full; the kernel reads and writes a
    parameter and its accumulator only where the gradient's bits are not
    all zero, which changes nothing in the result: a zero gradient leaves
    both as they are. Updates are in place."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-2):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.sum_of_squares: List[torch.Tensor] = [
            torch.full_like(p, INITIAL_ACCUMULATOR, memory_format=torch.contiguous_format)
            for p in self.params
        ]

    def accumulator(self, param: torch.Tensor) -> torch.Tensor:
        """The sum of squares kept for ``param``."""
        for p, acc in zip(self.params, self.sum_of_squares):
            if p is param:
                return acc
        raise KeyError("parameter not managed by this optimizer")

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        # a parameter without a gradient has a zero one: optax would leave it unchanged
        live = [(p, acc) for p, acc in zip(self.params, self.sum_of_squares) if p.grad is not None]
        adagrad_update([p for p, _ in live], [acc for _, acc in live], [p.grad for p, _ in live], self.lr)


LossFn = Callable[[torch.nn.Module, Dict[str, torch.Tensor]], torch.Tensor]


def train_step(model, optimizer: Adagrad, batch: Dict[str, torch.Tensor], loss_fn: LossFn = dlrm_loss) -> torch.Tensor:
    """One optimizer step of ``loss_fn`` on ``batch`` → the loss before it
    (a 0-d tensor on the model's device)."""
    optimizer.zero_grad()
    loss = loss_fn(model, batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_chunk(model, optimizer: Adagrad, chunk: Dict[str, torch.Tensor], batch_size: int,
                loss_fn: LossFn = dlrm_loss) -> torch.Tensor:
    """Trains over every full batch of a chunk's arrays in order → losses
    [n // batch_size] on the device (rows past the last full batch are
    dropped, as a drop_last loader would)."""
    n = next(iter(chunk.values())).shape[0]
    losses = []
    for start in range(0, n // batch_size * batch_size, batch_size):
        batch = {k: v[start : start + batch_size] for k, v in chunk.items()}
        losses.append(train_step(model, optimizer, batch, loss_fn))
    if not losses:
        return torch.empty(0)
    return torch.stack(losses)


def process_epoch(loader: Iterable[Dict[str, torch.Tensor]], model,
                  optimizer: Optional[Adagrad] = None, loss_fn: LossFn = dlrm_loss,
                  label_key: str = "label") -> Dict[str, float]:
    """One pass over the loader. With ``optimizer``: train, and report the
    mean loss. Without: evaluate, and report AUC and logloss against
    ``batch[label_key]`` (JAX training.py:85)."""
    losses = []
    logits_all, labels_all = [], []
    for batch in loader:
        if optimizer is not None:
            losses.append(train_step(model, optimizer, batch, loss_fn))
        else:
            with torch.no_grad():
                logits_all.append(model(batch).float().reshape(-1).cpu().numpy())
            labels_all.append(batch[label_key].float().cpu().numpy())
    metrics: Dict[str, float] = {}
    if losses:
        metrics["loss"] = float(torch.stack(losses).float().mean())
    if logits_all:
        logits = np.concatenate(logits_all)
        labels = np.concatenate(labels_all)
        metrics["auc"] = roc_auc(labels, logits)
        p = 1.0 / (1.0 + np.exp(-logits))
        eps = 1e-7
        metrics["logloss"] = float(-np.mean(labels * np.log(p + eps) + (1 - labels) * np.log(1 - p + eps)))
    return metrics


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (exact, ties averaged) — the Criteo parity metric."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    tie_starts = np.concatenate(([True], sorted_scores[1:] != sorted_scores[:-1]))
    group_id = np.cumsum(tie_starts) - 1
    group_sum = np.bincount(group_id, weights=np.arange(1, len(scores) + 1))
    group_cnt = np.bincount(group_id)
    ranks[order] = (group_sum / group_cnt)[group_id]
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)
