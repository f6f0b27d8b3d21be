"""Text-prompted segmentation backends for local editing.

JAX counterpart: ``dge_tpu/systems/segmentation.py``. Reference analog:
LangSAMTextSegmentor (threestudio/utils/sam.py:14-63), lang-segment-anything
with a full-mask fallback on failure. The contract is a per-view [H, W]
float mask in {0, 1} for a text prompt:

- ``precomputed``: mask PNGs from a directory, one per view id, read with
  the port's own image codec (utils/saving.load_image)
- ``torch_sam``: lang_sam / segment-anything where importable (gated)
- ``sam2``: SAM 2.1 (``models/sam2``) over a batch of views on the device,
  one box prompt a view (``Sam2Segmentor.segment``; ``DGESystem.segment_views``
  projects a scene-space box into each view in place of lang-sam's
  GroundingDINO box)
- fallback: the full-image mask, the reference's failure behaviour, also
  ``sam2``'s for a box that misses its view

Spans ``seg.encode`` (input resize and normalisation, trunk, neck and the
high-resolution features) and ``seg.decode`` (prompts, decoder, stability
selection, resize and threshold), each per batch (eager batches only: on a
card a batch is a CUDA graph replay outside ``tracing.recording()``); the
counter group ``segment_counts`` (``views``, ``batches``, ``fallbacks``,
``captures``, ``replays``); one host read a call,
``host_syncs["seg.fallbacks"]`` (utils/tracing.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dge_tpu_torch.models import sam2 as M
from dge_tpu_torch.ops.projection import NEAR_Z, ndc2pix
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.utils import saving, tracing

# views segmented, encoder batches, views whose box missed them (given the
# full mask), and the CUDA graphs' captures and replays (batches on a card)
segment_counts = tracing.group("segment_counts", {
    "views": 0, "batches": 0, "fallbacks": 0, "captures": 0, "replays": 0})


def full_mask_segmentor(image: np.ndarray, prompt: str) -> np.ndarray:
    """Reference fallback: everything is editable (sam.py:31-63)."""
    return np.ones(image.shape[:2], np.float32)


def _resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.INTER_NEAREST: source index floor(dst · src / dst)."""
    ys = np.minimum((np.arange(h) * (m.shape[0] / h)).astype(int),
                    m.shape[0] - 1)
    xs = np.minimum((np.arange(w) * (m.shape[1] / w)).astype(int),
                    m.shape[1] - 1)
    return m[ys][:, xs]


def precomputed_segmentor(mask_dir: str) -> Callable:
    """Masks from ``<mask_dir>/<view_id:04d>.png`` (grayscale, >127 = in)."""
    state = {"next_id": 0}

    def seg(image: np.ndarray, prompt: str, view_id: Optional[int] = None):
        vid = state["next_id"] if view_id is None else view_id
        if view_id is None:
            state["next_id"] += 1
        path = os.path.join(mask_dir, f"{vid:04d}.png")
        if not os.path.exists(path):
            return full_mask_segmentor(image, prompt)
        m = np.round(saving.load_image(path)[..., 0] * 255.0)
        if m.shape != image.shape[:2]:
            m = _resize_nearest(m, *image.shape[:2])
        return (m > 127).astype(np.float32)

    return seg


def torch_sam_segmentor() -> Callable:
    """lang_sam-backed segmentor when the package and its weights exist
    locally; mirrors LangSAMTextSegmentor's predict and fallback
    (sam.py:22-63)."""
    try:
        from lang_sam import LangSAM  # type: ignore

        model = LangSAM()
    except Exception:  # the optional package or its weights are missing
        return full_mask_segmentor

    def seg(image: np.ndarray, prompt: str):
        try:
            from PIL import Image

            pil = Image.fromarray(
                (np.clip(image, 0, 1) * 255).astype(np.uint8))
            masks = model.predict([pil], [prompt])[0]["masks"]
            if len(masks) == 0:
                return full_mask_segmentor(image, prompt)
            return np.asarray(masks[0]).astype(np.float32)
        except Exception:  # the reference's fallback on a failed predict
            return full_mask_segmentor(image, prompt)

    return seg


@dataclasses.dataclass
class SegmentOut:
    """What ``Sam2Segmentor.segment`` gives for V views, on the device."""

    masks: torch.Tensor  # f32 {0, 1} [V, H, W]; all ones where ~hit
    logits: torch.Tensor  # f32 [V, n, h, w]: every mask token's low-res map
    iou: torch.Tensor  # f32 [V, n]
    object_scores: torch.Tensor  # f32 [V, 1] (logits)
    stability: torch.Tensor  # f32 [V]: mask 0's stability score
    choice: torch.Tensor  # long [V]: the mask token each view took
    hit: torch.Tensor  # bool [V]: the box overlaps the view


def project_box(box: Sequence[float], cams: CameraArrays) -> torch.Tensor:
    """The scene-space box (x0, y0, z0, x1, y1, z1) in each of the stacked
    views ``cams``: [V, 4] pixel bounds (x0, y0, x1, y1) of its corners in
    front of the camera (depth > ``NEAR_Z``), clipped to the view, as a
    detector's box would be; empty (x1 <= x0 or y1 <= y0) where nothing of
    the box is in view."""
    lo, hi = np.asarray(box, np.float32).reshape(2, 3)
    corners = np.array([[(lo, hi)[i >> k & 1][k] for k in range(3)] + [1.0]
                        for i in range(8)], np.float32)
    hom = torch.from_numpy(corners).to(cams.w2c.device)
    depth = hom @ cams.w2c[:, 2].T  # [8, V]
    ph = torch.einsum("vij,cj->vci", cams.full_proj, hom)  # [V, 8, 4]
    front = depth.T > NEAR_Z
    px = ndc2pix(ph[..., 0] / ph[..., 3], cams.width)
    py = ndc2pix(ph[..., 1] / ph[..., 3], cams.height)
    inf = float("inf")
    return torch.stack([
        torch.where(front, px, inf).amin(1).clamp(0, cams.width),
        torch.where(front, py, inf).amin(1).clamp(0, cams.height),
        torch.where(front, px, -inf).amax(1).clamp(0, cams.width),
        torch.where(front, py, -inf).amax(1).clamp(0, cams.height)], -1)


class _BatchGraph:
    """One batch of ``Sam2Segmentor._batch`` captured in a CUDA graph with a
    private memory pool, for every later batch of its shape: each replay
    copies the images and box corners into the graph's own tensors, device
    to device, and clones the outputs out of its pool, which the next
    replay overwrites. The capture follows PyTorch's rule: one eager batch
    on a side stream first, so that the libraries' first-call set-up
    happens outside it."""

    def __init__(self, run, images, corners):
        self.inputs = [images.clone(), corners.clone()]
        with torch.cuda.device(images.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = run(*self.inputs)

    def replay(self, images, corners):
        torch._foreach_copy_(self.inputs, [images, corners])
        self.graph.replay()
        return tuple(t.clone() for t in self.out)


class Sam2Segmentor:
    """SAM 2.1's image predictor over a batch of views, one box each, as
    lang-sam calls it (``multimask_output=False``: dynamic selection via
    stability); the reference's full mask for a box that misses its view.
    Nothing is read on the host but the count of such boxes.

    On a card each batch shape is captured once in a CUDA graph
    (``_BatchGraph``) and replayed (``segment_counts``' ``captures`` and
    ``replays``); under ``tracing.recording()`` batches run eagerly, since
    spans are Python."""

    def __init__(self, model: M.Sam2Model):
        self.model = model
        self._graphs = {}  # batch shape -> _BatchGraph

    def _batch(self, images, corners):
        """One batch: ``images`` [n, H, W, 3] and box ``corners`` [n, 2, 2]
        in input pixels -> (masks bool [n, H, W], logits, iou, object
        scores, stability, choice)."""
        m, cfg = self.model, self.model.cfg
        n, h, w = images.shape[:3]
        with tracing.span("seg.encode", device=images.device, views=n):
            feats = m.encode(M.prepare(images, cfg.image_size))
        with tracing.span("seg.decode", device=images.device, views=n):
            logits, iou, obj = m.decode(feats, corners)
            chosen, choice, stab = M.select_masks(
                logits, iou, cfg.stability_delta, cfg.stability_thresh)
            masks = F.interpolate(chosen[:, None], size=(h, w),
                                  mode="bilinear",
                                  align_corners=False)[:, 0] > 0.0
        return masks, logits, iou, obj, stab, choice

    def _run(self, images, corners):
        if not images.is_cuda or tracing.is_recording():
            return self._batch(images, corners)
        key = tuple(images.shape)
        if key not in self._graphs:
            self._graphs[key] = _BatchGraph(self._batch, images, corners)
            segment_counts["captures"] += 1
        segment_counts["replays"] += 1
        return self._graphs[key].replay(images, corners)

    def segment(self, images: torch.Tensor, boxes: torch.Tensor,
                batch: int = 5) -> SegmentOut:
        """``images`` [V, H, W, 3] in [0, 1] and ``boxes`` [V, 4] (x0, y0,
        x1, y1) in their pixels, on the model's device; ``batch`` images an
        encoder call."""
        v, h, w = images.shape[:3]
        s = self.model.cfg.image_size
        hit = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        corners = torch.stack([boxes[:, 0::2].float() * (s / w),
                               boxes[:, 1::2].float() * (s / h)], -1)
        parts = [self._run(images[i:i + batch], corners[i:i + batch])
                 for i in range(0, v, batch)]
        masks, logits, iou, obj, stab, choice = (torch.cat(p)
                                                 for p in zip(*parts))
        masks = torch.where(hit[:, None, None], masks.float(), 1.0)
        segment_counts["views"] += v
        segment_counts["batches"] += len(parts)
        segment_counts["fallbacks"] += tracing.host_read(
            (~hit).sum(), "seg.fallbacks")
        return SegmentOut(masks, logits, iou, obj, stab, choice, hit)


def build_segmentor(kind: str = "fallback", mask_dir: str = "", **sam2):
    """The segmentor ``kind``; ``sam2``'s keywords build its network once
    (``models/sam2.build_model``: ``cfg``, ``device``, ``dtype``,
    ``params`` or ``checkpoint``, ``seed``)."""
    if kind == "precomputed":
        return precomputed_segmentor(mask_dir)
    if kind == "torch_sam":
        return torch_sam_segmentor()
    if kind == "sam2":
        return Sam2Segmentor(M.build_model(**sam2))
    return full_mask_segmentor
