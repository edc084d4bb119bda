"""Dataset registry: name -> constructor, list -> concat.

Port of `plangen_tpu/data/registry.py` for the one dataset the port has:
`toy`. The real datasets (LayoutSAM, GRiT, OIM, COCO, layout plans) are not
ported; their names raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Union

from plangen_tpu_torch.config import PlanGenConfig


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= self._total:
            raise IndexError(idx)
        for ds, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if idx >= off:
                return ds[idx - off]
        raise IndexError(idx)


def _toy(cfg: PlanGenConfig, is_test: bool):
    from plangen_tpu_torch.data.toy import ToyDataset

    return ToyDataset(size=100, image_hw=cfg.janus_hw,
                      neg_prompt=cfg.generation.neg_prompt,
                      textual=cfg.use_textual)


REGISTRY: Dict[str, Callable] = {"toy": _toy}


def get_dataset(
    cfg: PlanGenConfig, name: Union[str, List[str]], is_test: bool = False
):
    """Build a dataset by registry name; a list of names concatenates."""
    if isinstance(name, (list, tuple)):
        return ConcatDataset([get_dataset(cfg, n, is_test) for n in name])
    if name not in REGISTRY:
        raise NotImplementedError(
            f"dataset {name!r} is not ported; the port knows {sorted(REGISTRY)}")
    return REGISTRY[name](cfg, is_test)
