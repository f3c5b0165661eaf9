"""Full-image evaluation by the reference protocol (counterpart:
``irdu_tpu/eval/harness.py``):

  * one ``np.random.RandomState(2204)`` per dataset, noise drawn per image
    in index order: ``+ N(0, σ/255)``;
  * reflect pad (edge sample not repeated) bottom/right to a multiple of 16,
    or of ``bucket``;
  * forward, crop back, clamp to [0, 1];
  * quantize with ``img_as_ubyte``, PSNR against the uint8 truth.

``forward`` maps a float32 numpy batch (B, H, W, 3) to the restored batch,
as a numpy array or a torch tensor on any device (``predict.batch_forward``
gives one for a model). ``evaluate_pairs_batched(device_metrics=True)``
scores on the output's device and reads back one scalar an image.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from irdu_tpu_torch.data.degradations import eval_noise
from irdu_tpu_torch.data.png import read_png, write_png
from irdu_tpu_torch.eval.metrics import img_as_ubyte, psnr_255


def pad_to_multiple(img: np.ndarray, factor: int = 16) -> tuple[np.ndarray, int, int]:
    """Reflect-pad bottom/right so H and W are multiples of ``factor``
    (numpy ``reflect``: the edge sample is not repeated). Returns
    (padded, orig_h, orig_w)."""
    h, w = img.shape[:2]
    pad_h = (factor - h % factor) % factor
    pad_w = (factor - w % factor) % factor
    if pad_h or pad_w:
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
    return img, h, w


def to_numpy(out) -> np.ndarray:
    """A forward's output as a float32 numpy array (a tensor is copied to the host)."""
    if isinstance(out, torch.Tensor):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


def evaluate_pairs(
    forward: Callable[[np.ndarray], object],
    images_255: Iterable[np.ndarray],
    sigma: float,
    *,
    seed: int = 2204,
    factor: int = 16,
    bucket: int | None = None,
    save_dir: str | None = None,
    save_tag: str = "LGU",
    dataset_name: str = "set",
    compute_ssim: bool = False,
    masks: Sequence[np.ndarray | None] | None = None,
) -> dict:
    """The protocol over uint8 HWC images, one image a call.

    bucket: pad to a multiple of ``bucket`` instead of ``factor`` (the
    output is cropped, so only the model's boundary sees it). masks: per
    image a boolean H×W array of pixels to leave out of an extra
    "masked_psnr", or None. save_dir: write the clean, noisy and denoised
    PNGs under the reference's names.

    Returns {"psnr": [...], "mean_psnr": float, "seconds": [...]}, with
    "masked_psnr"/"mean_masked_psnr" and "ssim"/"mean_ssim" when asked.
    """
    rs = np.random.RandomState(seed=seed)
    psnrs, times, ssims, masked_psnrs = [], [], [], []
    pad_factor = bucket if bucket else factor
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    for img_i, img_255 in enumerate(images_255):
        img_true_255 = img_255.astype(np.float32)
        img_true = img_true_255 / 255.0
        noisy = (img_true + eval_noise(img_true.shape, sigma, random_state=rs)).astype(np.float32)
        padded, h, w = pad_to_multiple(noisy, pad_factor)
        t0 = time.perf_counter()
        restored = to_numpy(forward(padded[None]))[0]
        times.append(time.perf_counter() - t0)
        restored = np.clip(restored[:h, :w], 0.0, 1.0)
        restored_255 = img_as_ubyte(restored).astype(np.float32)
        psnrs.append(psnr_255(img_true_255, restored_255))
        if masks is not None and masks[img_i] is not None:
            keep = ~np.asarray(masks[img_i], bool)
            masked_psnrs.append(psnr_255(img_true_255[keep], restored_255[keep]))
        if compute_ssim:
            from irdu_tpu_torch.eval.metrics import ssim_255

            ssims.append(ssim_255(img_true_255, restored_255))
        if save_dir:
            # "{dataset}_sigma{σ}_{img}_{tag}_denoised.png", the reference's names
            stem = f"{dataset_name}_sigma{int(sigma)}_{img_i:03d}"
            write_png(os.path.join(save_dir, f"{stem}_clean.png"), img_255.astype(np.uint8))
            write_png(os.path.join(save_dir, f"{stem}_noisy.png"),
                      img_as_ubyte(np.clip(noisy[:h, :w], 0, 1)))
            write_png(os.path.join(save_dir, f"{stem}_{save_tag}_denoised.png"),
                      restored_255.astype(np.uint8))
    out = {"psnr": psnrs, "mean_psnr": float(np.mean(psnrs)), "seconds": times}
    if masked_psnrs:
        out["masked_psnr"] = masked_psnrs
        out["mean_masked_psnr"] = float(np.mean(masked_psnrs))
    if compute_ssim:
        out["ssim"] = ssims
        out["mean_ssim"] = float(np.mean(ssims))
    return out


def score_batch(restored: torch.Tensor, true_pad: torch.Tensor, hs: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """The protocol's PSNR of each image of a padded batch over its valid
    (h, w) corner, on the batch's device: ``img_as_ubyte`` (clip, rint of
    ·255, clip) and ``psnr_255``. f64 throughout, so the squared errors,
    integers, sum exactly and the result is the host path's."""
    q = torch.clamp(torch.round(restored.double().clamp(0.0, 1.0) * 255.0), 0.0, 255.0)
    hgrid = torch.arange(restored.shape[1], device=restored.device)[None, :, None, None]
    wgrid = torch.arange(restored.shape[2], device=restored.device)[None, None, :, None]
    mask = (hgrid < hs[:, None, None, None]) & (wgrid < ws[:, None, None, None])
    se = ((q - true_pad.double()).square() * mask).sum(dim=(1, 2, 3))
    mse = se / (hs * ws * restored.shape[3]).double()
    return 20.0 * np.log10(255.0) - 10.0 * torch.log10(mse)


def evaluate_pairs_batched(
    forward: Callable[[np.ndarray], object],
    images_255: Sequence[np.ndarray],
    sigma: float,
    *,
    seed: int = 2204,
    bucket: int = 64,
    batch_size: int = 4,
    device_metrics: bool = False,
) -> dict:
    """``evaluate_pairs`` in fixed-size batches: the images are grouped by
    their shape padded to ``bucket`` and stacked ``batch_size`` at a time; a
    short batch repeats its last image, so each bucket runs one batch shape.
    The noise is the protocol's (one RandomState(seed), index order), so the
    per-image PSNRs are ``evaluate_pairs``' up to the model's sensitivity to
    the pad.

    forward: (batch_size, H, W, 3) float32 → the same shape.
    device_metrics: quantize, crop and score on the output's device
    (``score_batch``) and read back one scalar an image instead of the
    images. Each bucket's shape is run once before the clock starts.
    Returns {"psnr", "mean_psnr", "seconds_total", "mp_per_s"}.
    """
    images = list(images_255)
    rs = np.random.RandomState(seed=seed)
    noisies = []
    for img_255 in images:  # index-order noise draw (the protocol)
        img_true = img_255.astype(np.float32) / 255.0
        noisies.append((img_true + eval_noise(img_true.shape, sigma, random_state=rs))
                       .astype(np.float32))

    groups: dict[tuple[int, int], list[int]] = {}
    padded = []
    for i, noisy in enumerate(noisies):
        p, _, _ = pad_to_multiple(noisy, bucket)
        padded.append(p)
        groups.setdefault(p.shape[:2], []).append(i)
    trues_pad = [np.pad(im.astype(np.float32), ((0, p.shape[0] - im.shape[0]),
                                                 (0, p.shape[1] - im.shape[1]), (0, 0)))
                 for im, p in zip(images, padded)]
    psnrs = [0.0] * len(images)

    def run(fill):
        out = forward(np.stack([padded[i] for i in fill]))
        if not device_metrics:
            return to_numpy(out)
        out = out if isinstance(out, torch.Tensor) else torch.from_numpy(np.asarray(out))
        tp = torch.from_numpy(np.stack([trues_pad[i] for i in fill])).to(out.device)
        hs, ws = (torch.tensor([images[i].shape[k] for i in fill], device=out.device)
                  for k in (0, 1))
        return score_batch(out, tp, hs, ws).cpu().numpy()

    for key in groups:  # the shapes' first runs (allocator, cuDNN plans) before the clock
        run([groups[key][0]] * batch_size)

    t0 = time.perf_counter()
    for key, idxs in groups.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            fill = chunk + [chunk[-1]] * (batch_size - len(chunk))
            out = run(fill)
            for j, i in enumerate(chunk):
                if device_metrics:
                    psnrs[i] = float(out[j])
                else:
                    h, w = images[i].shape[:2]
                    restored_255 = img_as_ubyte(np.clip(out[j, :h, :w], 0.0, 1.0))
                    psnrs[i] = psnr_255(images[i].astype(np.float32),
                                        restored_255.astype(np.float32))
    seconds = time.perf_counter() - t0
    true_px = sum(im.shape[0] * im.shape[1] for im in images)
    return {"psnr": psnrs, "mean_psnr": float(np.mean(psnrs)), "seconds_total": seconds,
            "mp_per_s": true_px / seconds / 1e6}


def read_image_index(csv_path: str) -> list[dict]:
    """The rows of a dataset's CSV index (path, height, width, nchannels)."""
    with open(csv_path, newline="") as fh:
        return [{"path": row["path"], "height": int(row["height"]),
                 "width": int(row["width"]), "nchannels": int(row["nchannels"])}
                for row in csv.DictReader(fh)]


def load_benchmark_images(csv_path: str, root_folder: str) -> list[np.ndarray]:
    """The PNG images a CSV index names, as uint8 arrays (``data/png.py``,
    which reads them as ``np.array(PIL.Image.open(p))`` does)."""
    return [read_png(os.path.join(root_folder, info["path"]))
            for info in read_image_index(csv_path)]


def load_masks(csv_path: str, mask_dir: str) -> list[np.ndarray | None]:
    """Per image of a CSV index, its suspect-pixel mask as a boolean H×W
    array (pixel > 127), or None where it has none: the mask of
    ``<stem>.png`` is ``<stem with "_true" as "_suspect">.png`` in
    ``mask_dir`` (``scripts/eval_natural_benchmark.py``'s rule)."""
    masks = []
    for info in read_image_index(csv_path):
        stem = os.path.splitext(os.path.basename(info["path"]))[0]
        path = os.path.join(mask_dir, stem.replace("_true", "_suspect") + ".png")
        masks.append(read_png(path) > 127 if os.path.exists(path) else None)
    return masks


def run_benchmark_eval(forward: Callable, datasets: dict[str, tuple[str, str]],
                       sigma: float = 25.0, batched: bool = False, **kwargs) -> dict[str, dict]:
    """Several benchmark sets, {name: (csv_path, root_folder)} → {name:
    result}, through ``evaluate_pairs`` or, with ``batched``,
    ``evaluate_pairs_batched``."""
    results = {}
    for name, (csv_path, root) in datasets.items():
        images = load_benchmark_images(csv_path, root)
        if batched:
            results[name] = evaluate_pairs_batched(forward, images, sigma, **kwargs)
        else:
            results[name] = evaluate_pairs(forward, images, sigma, dataset_name=name, **kwargs)
    return results
