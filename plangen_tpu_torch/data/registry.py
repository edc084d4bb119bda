"""Dataset registry: name -> constructor, list -> concat.

A copy of `plangen_tpu/data/registry.py` with every name of its `REGISTRY`,
keyed the same way; an unknown name raises `KeyError` as there.
tests/test_torch_datasets.py holds the names and the datasets equal.

TPU-native replacement for the reference's `set_dataset.py` registry
(set_dataset.py:7-122): string names map to dataset factories; a list of
names concatenates. The reference's dead names (`mb`, `gen` — undefined
classes, data_hico.py:90,102) and the duplicate `plan_r1` key
(set_dataset.py:54-59) are not replicated.
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


def _layoutsam_eval(cfg, is_test, limit=None):
    from plangen_tpu_torch.data.layoutsam import LayoutSAMEval

    path = getattr(cfg, "layoutsam_eval_path", None) or ""
    return LayoutSAMEval(
        path, image_hw=cfg.janus_hw, limit=limit,
        neg_prompt=cfg.generation.neg_prompt, textual=cfg.use_textual
    )


def _layoutsam_train(cfg, is_test):
    from plangen_tpu_torch.data.layoutsam import LayoutSAMEval, LayoutSAMTrain

    if is_test:
        return _layoutsam_eval(cfg, is_test)
    path = getattr(cfg, "layoutsam_path", None) or ""
    return LayoutSAMTrain(
        path,
        image_hw=cfg.janus_hw,
        neg_prompt=cfg.generation.neg_prompt,
        image_root=getattr(cfg, "layoutsam_image_root", "") or "",
        textual=cfg.use_textual,
    )


def _coco(cfg, is_test):
    from plangen_tpu_torch.data.coco import COCOValDataset

    root = getattr(cfg, "coco_root", None) or ""
    return COCOValDataset(
        ann_file=f"{root}/annotations/instances_val2017.json",
        caption_file=f"{root}/annotations/captions_val2017.json",
        image_dir=f"{root}/val2017",
        image_hw=cfg.janus_hw,
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


def _edit_coco(cfg, is_test):
    from plangen_tpu_torch.data.coco import EditCoco200

    return EditCoco200(
        getattr(cfg, "coco_200_path", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        pad_edit_box=cfg.generation.pad_edit_box,
        textual=cfg.use_textual,
    )


def _rm_coco(cfg, is_test):
    from plangen_tpu_torch.data.coco import RmCoco200

    return RmCoco200(
        getattr(cfg, "coco_200_path", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


def _layout(cfg, is_test):
    from plangen_tpu_torch.data.layoutgpt import NSR1KLayoutDataset

    return NSR1KLayoutDataset(
        getattr(cfg, "nsr1k_path", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


def _oim(cfg, is_test):
    from plangen_tpu_torch.data.oim import OpenImagesDataset

    return OpenImagesDataset(
        data_root=getattr(cfg, "oim_root", None) or "",
        class_csv=getattr(cfg, "oim_class_csv", None) or "",
        caption_dir=getattr(cfg, "oim_caption_dir", None),
        image_hw=cfg.janus_hw,
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


def _grit(cfg, is_test, flip=False):
    from plangen_tpu_torch.data.grit import GritSceneGraphDataset

    return GritSceneGraphDataset(
        getattr(cfg, "grit_json", None) or "",
        image_dir=getattr(cfg, "grit_image_dir", ""),
        image_hw=cfg.janus_hw,
        flip=flip,
        neg_prompt=cfg.generation.neg_prompt,
        # training-only augmentations (debug_grit.py:645,662)
        proportion_empty_prompts=(
            0.0 if is_test else getattr(cfg, "grit_empty_prompt_prob", 0.0)
        ),
        use_min_iou_crop=(
            False if is_test else getattr(cfg, "grit_min_iou_crop", False)
        ),
        textual=cfg.use_textual,
    )


def _grit7k(cfg, is_test):
    from plangen_tpu_torch.data.grit import Grit7kDataset

    return Grit7kDataset(
        getattr(cfg, "grit7k_json", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


def _edit_spec(cfg, is_test):
    from plangen_tpu_torch.data.grit import EditSpecDataset

    return EditSpecDataset(
        getattr(cfg, "edit_json", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        pad_edit_box=cfg.generation.pad_edit_box,
        textual=cfg.use_textual,
    )


def _plan_eval(cfg, is_test):
    from plangen_tpu_torch.data.layoutgpt import PlanEvalDataset

    return PlanEvalDataset(
        getattr(cfg, "plan_json", None) or "",
        getattr(cfg, "plan_caps_jsonl", None) or "",
        neg_prompt=cfg.generation.neg_prompt,
        textual=cfg.use_textual,
    )


REGISTRY: Dict[str, Callable] = {
    "toy": _toy,
    "data_toy": _toy,
    "creati": _layoutsam_eval,  # LayoutSAM-eval test split
    "1k": lambda cfg, t: _layoutsam_eval(cfg, t, limit=1000),
    "sam": _layoutsam_train,
    "coco": _coco,
    "edit_coco": _edit_coco,
    "rm_coco": _rm_coco,
    "coco_rm": _rm_coco,
    "layout": _layout,
    "oim": _oim,
    "hico": _grit,  # GRiT scene-graph subset
    "hico_full": lambda cfg, t: _grit(cfg, t, flip=False),
    "hico_7k": _grit7k,
    "edit": _edit_spec,
    "plan": _plan_eval,  # pre-generated LLM plans ('plan_llama' etc. share this)
}


def get_dataset(
    cfg: PlanGenConfig, name: Union[str, List[str]], is_test: bool = False
):
    """Build a dataset by registry name; a list of names concatenates
    (reference set_dataset.py:69-75)."""
    if isinstance(name, (list, tuple)):
        return ConcatDataset([get_dataset(cfg, n, is_test) for n in name])
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](cfg, is_test)
