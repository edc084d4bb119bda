"""Built-in image-quality metrics: FID and KID over SigLIP features.

Port of `plangen_tpu/tasks/image_metrics.py`. The math (`feature_stats`,
`frechet_distance`, `kid_poly`, `fid_kid_from_features`) and
`load_image_dir` are copies in fp64 numpy; tests/test_torch_eval.py holds
them equal to the JAX ones.

`SigLIPFeaturizer` runs the pipeline model's SigLIP tower
(`model.vision_model`, which no quantized form touches) on the model's
device: images in the [-1, 1] convention, resized to the tower's input
size when they differ, rounded to bf16 as the JAX featurizer does, then the
mean over the patch features in fp32. The JAX resize is
`jax.image.resize(..., "linear", antialias=True)`: a triangle filter over
half-pixel centers, widened by the scale when shrinking. The port's is
`F.interpolate(mode="bilinear", antialias=True, align_corners=False)`, the
same filter (tests/test_torch_eval.py holds the two within 1e-6 on [-1, 1]
images when shrinking, 1e-4 when enlarging). The JAX featurizer pads each batch to a
fixed size to compile once; the port compiles nothing and does not pad.

Feature model = the framework's own SigLIP-L/16-384 tower, so absolute
values are not comparable to Inception-FID numbers from the literature;
`TorchScriptFeaturizer` takes an external TorchScript feature module (e.g.
a scripted pytorch-fid InceptionV3) for those.

Math: FID (Heusel et al. 2017) with tr sqrt(S1 S2) from the symmetric eigh
of sqrt(S1) S2 sqrt(S1); KID (Binkowski et al. 2018), the unbiased
polynomial-kernel MMD^2, mean and std over subsets.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "feature_stats",
    "frechet_distance",
    "kid_poly",
    "SigLIPFeaturizer",
    "TorchScriptFeaturizer",
    "make_featurizer",
    "fid_kid_from_features",
    "load_image_dir",
]


# --------------------------------------------------------------------- math


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of a feature matrix [N, D] in fp64."""
    f = np.asarray(feats, dtype=np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"need [N>=2, D] features, got {f.shape}")
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrt_trace_of_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr sqrtm(sigma1 @ sigma2) for PSD sigma1/sigma2, via eigh.

    With A = sqrtm(sigma1) (symmetric PSD), sigma1@sigma2 is similar to
    A @ sigma2 @ A, which is symmetric PSD — its eigenvalues are real and
    the trace of the sqrt is the sum of their square roots.
    """
    w1, v1 = np.linalg.eigh(sigma1)
    a = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = a @ sigma2 @ a
    w = np.linalg.eigvalsh((m + m.T) / 2.0)
    return float(np.sqrt(np.clip(w, 0.0, None)).sum())


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """||mu1-mu2||² + tr(Σ1 + Σ2 - 2·sqrtm(Σ1Σ2)), clipped at 0."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = float(((mu1 - mu2) ** 2).sum())
    cov_term = float(np.trace(sigma1) + np.trace(sigma2)) - 2.0 * (
        _sqrt_trace_of_product(sigma1, sigma2)
    )
    return max(0.0, diff + cov_term)


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def _mmd2_unbiased(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased MMD² estimate between equal-size blocks x, y [m, D]."""
    m = x.shape[0]
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    sum_off = lambda k: (k.sum() - np.trace(k)) / (m * (m - 1))
    return float(sum_off(kxx) + sum_off(kyy) - 2.0 * kxy.mean())


def kid_poly(
    feats1: np.ndarray,
    feats2: np.ndarray,
    n_subsets: int = 100,
    subset_size: Optional[int] = None,
    seed: int = 0,
) -> Tuple[float, float]:
    """KID mean ± std via the standard subset estimator (deterministic seed)."""
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    m = min(len(f1), len(f2), subset_size or 1000)
    if m < 2:
        raise ValueError("KID needs at least 2 samples per side")
    if m >= len(f1) and m >= len(f2):
        # no subsampling possible: every "subset" is a permutation of the
        # full sets and the unbiased MMD is permutation-invariant — compute
        # once; std 0.0 here means "no subsampling", not high confidence
        return _mmd2_unbiased(f1, f2), 0.0
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        i = rng.choice(len(f1), m, replace=False)
        j = rng.choice(len(f2), m, replace=False)
        vals.append(_mmd2_unbiased(f1[i], f2[j]))
    return float(np.mean(vals)), float(np.std(vals))


def fid_kid_from_features(
    gt_feats: np.ndarray, pr_feats: np.ndarray, kid_subsets: int = 100,
    tag: str = "siglip",
) -> Dict[str, float]:
    """Both metrics from two feature matrices; keys carry the feature model
    (`tag`) so an Inception-feature run is never mistaken for a SigLIP one."""
    mu1, s1 = feature_stats(gt_feats)
    mu2, s2 = feature_stats(pr_feats)
    kid_mean, kid_std = kid_poly(gt_feats, pr_feats, n_subsets=kid_subsets)
    return {
        f"fid_{tag}": frechet_distance(mu1, s1, mu2, s2),
        f"kid_{tag}": kid_mean,
        f"kid_{tag}_std": kid_std,
        "n_gt": float(len(gt_feats)),
        "n_pr": float(len(pr_feats)),
    }


# ------------------------------------------------------------- feature model


class SigLIPFeaturizer:
    """Mean-pooled SigLIP patch features for image batches, on the device of
    `model.vision_model`. Accepts uint8 [0, 255] or float [-1, 1] images of
    any H x W (resized on the device to the tower's input size)."""

    def __init__(self, model, model_cfg, batch_size: int = 16):
        import torch

        self._torch = torch
        self.batch = int(batch_size)
        self.vision = model.vision_model
        param = next(self.vision.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.size = model_cfg.vision.image_size

    @staticmethod
    def to_model_range(images: np.ndarray) -> np.ndarray:
        """uint8 [0,255] -> float32 [-1,1]; float input passes through."""
        if images.dtype == np.uint8:
            from plangen_tpu_torch.data.preprocess import to_model_range

            return to_model_range(images)
        return np.asarray(images, np.float32)

    def _feats(self, chunk: np.ndarray) -> np.ndarray:
        torch = self._torch
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        if x.shape[1] != self.size or x.shape[2] != self.size:
            x = resize_linear_antialias(x, self.size)
        with torch.inference_mode():
            feats = self.vision(x.to(torch.bfloat16).to(self.dtype))
        return feats.float().mean(dim=1).cpu().numpy()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images [N, H, W, 3] (uint8 or [-1,1] float) -> fp32 [N, width]."""
        x = self.to_model_range(np.asarray(images))
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"need [N, H, W, 3] images, got {x.shape}")
        return np.concatenate([self._feats(x[s:s + self.batch])
                               for s in range(0, len(x), self.batch)], axis=0)


def resize_linear_antialias(images, size: int):
    """[N, H, W, C] float -> [N, size, size, C]: the counterpart of
    `jax.image.resize(images, (N, size, size, C), "linear", antialias=True)`."""
    import torch.nn.functional as F

    x = images.float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1)


class TorchScriptFeaturizer:
    """Features from an EXTERNAL TorchScript module, for literature-comparable
    FID: script the feature model once

        m = torch.jit.trace(feature_model.eval(), example_nchw)
        m.save("inception_feats.pt")

    (for pytorch-fid parity: their `InceptionV3([3])` wrapper, whose forward
    returns pool3 features) and point `cli metrics --features torch:<path>`
    at it. The FID math on top is this module's.

    Contract: module(float32 NCHW in [0,1] at `size`) -> [N, D]; tuple/list
    outputs take the first element; trailing 1x1 spatial dims are squeezed
    (the pytorch-fid wrapper's output shape is [N,2048,1,1]). The module
    runs on `device`.
    """

    def __init__(self, path: str, size: int = 299, batch_size: int = 16, device="cpu"):
        import torch

        self._torch = torch
        self.size = int(size)
        self.batch = int(batch_size)
        self.device = torch.device(device)
        self.mod = torch.jit.load(path, map_location=self.device).eval()

    def _unit_range(self, images: np.ndarray) -> np.ndarray:
        """uint8 [0,255] or float [-1,1] -> float32 [0,1]."""
        if images.dtype == np.uint8:
            return images.astype(np.float32) / 255.0
        x = np.asarray(images, np.float32)
        return np.clip((x + 1.0) / 2.0, 0.0, 1.0)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        torch = self._torch
        x = self._unit_range(np.asarray(images))
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"need [N, H, W, 3] images, got {x.shape}")
        out = []
        with torch.no_grad():
            for s in range(0, len(x), self.batch):
                t = torch.from_numpy(x[s : s + self.batch]).permute(0, 3, 1, 2)
                t = t.to(self.device)
                if t.shape[-1] != self.size or t.shape[-2] != self.size:
                    t = torch.nn.functional.interpolate(
                        t, size=(self.size, self.size), mode="bilinear",
                        align_corners=False,
                    )
                y = self.mod(t)
                if isinstance(y, (tuple, list)):
                    y = y[0]
                y = y.reshape(y.shape[0], -1)  # squeeze [N,D,1,1] -> [N,D]
                out.append(y.cpu().numpy().astype(np.float32))
        return np.concatenate(out, axis=0)


def make_featurizer(spec: str, model, model_cfg, batch_size: int = 16,
                    size: int = 299, device="cpu"):
    """'siglip' (the model's own tower, on its device) or 'torch:<path>'
    (on `device`) -> (featurizer, tag). The tag lands in the metric keys
    (fid_<tag>) so reports are self-describing about comparability."""
    if spec == "siglip":
        return SigLIPFeaturizer(model, model_cfg, batch_size=batch_size), "siglip"
    if spec.startswith("torch:"):
        path = spec[len("torch:"):]
        return TorchScriptFeaturizer(path, size=size, batch_size=batch_size,
                                     device=device), "torchscript"
    raise ValueError(
        f"unknown --features {spec!r}; options: 'siglip' or 'torch:<path>' "
        "(a TorchScript feature module, e.g. scripted pytorch-fid "
        "InceptionV3 for literature-comparable numbers)"
    )


# ------------------------------------------------------------ directory mode


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image_dir(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Read every image in a directory (sorted) -> uint8 [N,H,W,3].

    This is the weights-day entry: point it at the gt_image/ and pr_image/
    trees an eval run wrote (tasks/eval.py artifact layout) and compute
    FID/KID without re-running generation. Stays uint8 (4x smaller than
    float) — SigLIPFeaturizer converts per compiled batch, so a 10k-image
    tree costs ~4.4 GB host RAM instead of ~18.
    """
    from PIL import Image

    names = sorted(
        n for n in os.listdir(path) if n.lower().endswith(_IMG_EXTS)
    )
    if limit is not None:
        names = names[:limit]
    if not names:
        raise ValueError(f"no images under {path}")
    imgs = []
    shape = None
    for n in names:
        img = Image.open(os.path.join(path, n)).convert("RGB")
        if shape is not None and img.size != (shape[1], shape[0]):
            # mixed sizes: resize on host to the first image's shape
            img = img.resize((shape[1], shape[0]), Image.BICUBIC)
        arr = np.asarray(img, dtype=np.uint8)
        if shape is None:
            shape = arr.shape
        imgs.append(arr)
    return np.stack(imgs)
