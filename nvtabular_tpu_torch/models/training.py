"""Training helpers: the counterpart of ``nvtabular_tpu/models/training.py``.

``adagrad`` and ``Adagrad`` follow optax's ``adagrad`` (``scale_by_rss``
then the learning rate), not ``torch.optim.Adagrad``: the accumulator
starts at 0.1 rather than 0, and eps sits inside the square root; both run
kernel K18 in place. Over params trees (``dlrm_init`` and its kin) the JAX
package's ``make_step_fns`` and ``make_chunk_train_fn`` take
``loss_fn(params, batch)`` and ``adagrad(lr)``; over the ``nn.Module``s,
``train_step`` and ``train_chunk`` take ``loss_fn(model, batch)``
(``dlrm_loss`` by default) and an ``Adagrad``. Each chunk trainer is a
Python loop over the chunk's batches that leaves every loss on the device
(no host sync per step). ``process_epoch`` and ``roc_auc`` are copies.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.adagrad import adagrad_update
from .dlrm import dlrm_loss
from .pytree import tree_leaves, tree_map


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


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) → state``; here ``update(grads, state,
    params) → (params, state)`` applies the step in place, optax's
    ``update`` and ``apply_updates`` in one."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def adagrad(learning_rate: float) -> GradientTransformation:
    """``optax.adagrad(learning_rate)`` over params trees: ``init`` gives
    the accumulator tree at INITIAL_ACCUMULATOR; ``update`` runs
    ``Adagrad``'s step (kernel K18, one launch for up to 64 tensors) on
    every leaf in place. A gradient of None (a leaf the loss does not use)
    leaves its parameter and accumulator as they are, as optax's zero
    gradient does."""

    def init(params):
        return tree_map(lambda p: torch.full_like(p, INITIAL_ACCUMULATOR, memory_format=torch.contiguous_format),
                        params)

    def update(grads, state, params):
        live = [(p, acc, g) for p, acc, g in zip(tree_leaves(params), tree_leaves(state), tree_leaves(grads))
                if g is not None]
        with torch.no_grad():
            adagrad_update([p for p, _, _ in live], [acc for _, acc, _ in live], [g for _, _, g in live],
                           learning_rate)
        return params, state

    return GradientTransformation(init, update)


def make_step_fns(loss_fn: Callable, optimizer: GradientTransformation, forward_fn: Optional[Callable] = None):
    """→ (train_step, eval_step), the JAX package's pair, eager.

    ``train_step(params, opt_state, batch) → (params, opt_state, loss)``:
    the gradient of ``loss_fn(params, batch)`` with respect to every leaf
    of ``params``, then ``optimizer.update`` (in place); the loss is a 0-d
    tensor on the device. ``eval_step(params, batch) → forward_fn(params,
    batch)`` without gradients, or None without ``forward_fn``."""

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            loss = loss_fn(_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [None if g is None else g.contiguous() for g in grads]
        params, opt_state = optimizer.update(_like(params, grads), opt_state, params)
        return params, opt_state, loss.detach()

    def eval_step(params, batch):
        with torch.no_grad():
            return forward_fn(params, batch)

    return train_step, (eval_step if forward_fn is not None else None)


def make_chunk_train_fn(loss_fn: Callable, optimizer: GradientTransformation, batch_size: int):
    """→ ``train_chunk(params, opt_state, chunk) → (params, opt_state,
    losses)``: ``make_step_fns``' step over every full batch of the chunk's
    [n, ...] arrays in order, losses [n // batch_size] on the device (rows
    past the last full batch are dropped, as a drop_last loader would). An
    eager loop of one step a batch; the JAX package's is one jitted
    ``lax.scan``, whose counterpart, the chunk as one dispatch (a CUDA
    graph), is not ported yet (ROADMAP.md queue 1 item 9)."""
    train_step, _ = make_step_fns(loss_fn, optimizer)

    def train_chunk(params, opt_state, chunk: Dict[str, torch.Tensor]):
        losses = []
        for batch in _batches(chunk, int(batch_size)):
            params, opt_state, loss = train_step(params, opt_state, batch)
            losses.append(loss)
        return params, opt_state, _stacked(losses, chunk)

    return train_chunk


def _like(tree, leaves: List[Any]):
    """``leaves`` in ``tree``'s structure, in ``tree_leaves``' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _batches(chunk: Dict[str, torch.Tensor], batch_size: int) -> Iterator[Dict[str, torch.Tensor]]:
    n = next(iter(chunk.values())).shape[0]
    for start in range(0, n // batch_size * batch_size, batch_size):
        yield {k: v[start : start + batch_size] for k, v in chunk.items()}


def _stacked(losses: List[torch.Tensor], chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
    if not losses:
        return torch.empty(0, device=next(iter(chunk.values())).device)
    return torch.stack(losses)


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
    return _stacked([train_step(model, optimizer, batch, loss_fn) for batch in _batches(chunk, batch_size)], chunk)


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
