"""Device-resident training feed: transform → shuffle → batch on the card.

Counterpart of ``nvtabular_tpu/loader/device_loader.py``. A transformed
dataset's batches stay on the workflow's device (``to_batches(host=False)``);
each chunk is shuffled by one ``torch.randperm`` drawn from a generator on
the loader's device (seeded ``seed + epoch``) and one launch of kernel K14
(``kernels.permute.permute_rows``) that permutes every array of the chunk;
batches are contiguous slices. A list (multihot) categorical column is
padded to ``sparse_max[col]`` slots by one launch of kernel K11
(``kernels.ragged.ragged_to_padded``) per chunk, as
``<col>__values`` [n, L] and ``<col>__mask`` float32 [n, L], which K14 then
permutes with the other arrays. The JAX loader draws its permutations from
``jax.random``, so shuffled orders differ between the two; unshuffled
batches are identical.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch

from ..kernels.permute import permute_rows
from ..kernels.ragged import ragged_to_padded
from ..tags import Tags
from ..workflow.workflow import TransformedDataset, resolve_device


class DeviceLoader:
    """Batch iterator over a (transformed) dataset with the shuffle and the
    batching on ``device`` (``cuda:0`` unless the caller passes another).
    Batch layout as the JAX loader's: one [B] tensor per categorical column
    (its dtype kept, int32 codes from Categorify), ``dense`` float32
    [B, len(cont_names)] stacked in ``cont_names`` order, ``<col>__values``
    [B, L] and ``<col>__mask`` float32 [B, L] for a list categorical column
    padded to ``L = sparse_max[col]`` (taken from the schema's
    ``value_count`` max where ``sparse_max`` does not name the column), and
    ``label`` float32 [B] (one key per label column when there are
    several)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        cat_names: Optional[List[str]] = None,
        cont_names: Optional[List[str]] = None,
        label_names: Optional[List[str]] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        sparse_max: Optional[Dict[str, int]] = None,
        device=None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.sparse_max = dict(sparse_max or {})
        self.device = resolve_device(device)
        schema = dataset.schema
        self.cat_names = (
            list(cat_names) if cat_names is not None else [cs.name for cs in schema if Tags.CATEGORICAL in cs.tags]
        )
        self.cont_names = (
            list(cont_names) if cont_names is not None else [cs.name for cs in schema if Tags.CONTINUOUS in cs.tags]
        )
        self.label_names = (
            list(label_names) if label_names is not None else [cs.name for cs in schema if Tags.TARGET in cs.tags]
        )
        for cs in schema:
            if cs.is_list and cs.name not in self.sparse_max:
                vc = cs.properties.get("value_count") or {}
                if vc.get("max"):
                    self.sparse_max[cs.name] = int(vc["max"])
        self._epoch = 0

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + self._epoch)
        self._epoch += 1
        return gen

    def _source(self):
        if isinstance(self.dataset, TransformedDataset):
            return self.dataset.to_batches(host=False)
        return self.dataset.to_batches()

    def _shuffled(self, arrays: Dict[str, torch.Tensor], gen: torch.Generator) -> Dict[str, torch.Tensor]:
        n = next(iter(arrays.values())).shape[0]
        perm = torch.randperm(n, generator=gen, device=self.device)
        return permute_rows(arrays, perm)

    def chunks(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Permuted full-chunk array dicts, one per batch of the dataset, with
        no per-batch slicing: feed them to ``models.training.train_chunk``."""
        gen = self._generator()
        for chunk in self._source():
            arrays = self._device_arrays(chunk)
            yield self._shuffled(arrays, gen) if self.shuffle else arrays

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        gen = self._generator()
        carry: Optional[Dict[str, torch.Tensor]] = None
        for chunk in self._source():
            arrays = self._device_arrays(chunk)
            if carry is not None:
                arrays = {k: torch.cat([carry[k], v]) for k, v in arrays.items()}
                carry = None
            n = next(iter(arrays.values())).shape[0]
            if self.shuffle:
                arrays = self._shuffled(arrays, gen)
            full = n // self.batch_size * self.batch_size
            for start in range(0, full, self.batch_size):
                yield {k: v[start : start + self.batch_size] for k, v in arrays.items()}
            if full < n:
                carry = {k: v[full:] for k, v in arrays.items()}
        if carry is not None and not self.drop_last:
            yield carry

    def _device_arrays(self, chunk) -> Dict[str, torch.Tensor]:
        """A TableBatch (on any device) → the flat dict of the batch layout
        on the loader's device."""
        out: Dict[str, torch.Tensor] = {}
        for name in self.cont_names:
            if chunk[name].is_list:
                raise NotImplementedError(
                    f"DeviceLoader does not support list-valued continuous column {name!r}; use the host "
                    f"Loader (pad_lists) or pre-aggregate it"
                )
        dense = [chunk[name].values.to(self.device, torch.float32) for name in self.cont_names]
        if dense:
            out["dense"] = torch.stack(dense, dim=1)
        for name in self.cat_names:
            col = chunk[name]
            if not col.is_list:
                out[name] = col.values.to(self.device).contiguous()
                continue
            max_len = self.sparse_max.get(name)
            if max_len is None:
                raise ValueError(
                    f"multihot column {name!r} needs a static max length on device: pass "
                    f"sparse_max={{'{name}': L}} or set a value_count on the schema (silent truncation is "
                    f"not acceptable)"
                )
            out[f"{name}__values"], out[f"{name}__mask"] = ragged_to_padded(
                col.values.to(self.device).contiguous(), col.offsets.to(self.device, torch.int64).contiguous(),
                max_len,
            )
        for name in self.label_names:
            key = "label" if len(self.label_names) == 1 else name
            out[key] = chunk[name].values.to(self.device, torch.float32).contiguous()
        if not out:
            raise ValueError(
                "DeviceLoader selected no columns: pass cat_names/cont_names/label_names "
                "explicitly, or load a dataset whose schema carries CATEGORICAL/CONTINUOUS/TARGET tags"
            )
        return out
