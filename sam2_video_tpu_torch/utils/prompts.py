"""Host-side prompt generation for the data pipeline (counterpart of
``sam2_video_tpu/utils/prompts.py``): object masks from category masks,
point and box prompts, and the correction-click samplers. numpy and
scipy; the outputs are padded to static shapes (objects to
``max_objects``, points to ``num_pos + num_neg`` with label -1).

The JAX package cuts category masks into objects with OpenCV: an opening
by the 5x5 ellipse (erosion, then dilation) and ``connectedComponents``.
This module computes the same with ``scipy.ndimage``, bit for bit:

- the ellipse of ``cv2.getStructuringElement(MORPH_ELLIPSE, (5, 5))``
  (``ELLIPSE_5X5``);
- OpenCV's default borders: outside the image counts as 1 for the erosion
  and as 0 for the dilation;
- 8-connected labels numbered as OpenCV's default labelling (a scan over
  2 x 2 blocks) numbers them: by the first 2 x 2 block, in raster order of
  the blocks, that holds a pixel of the component. Two 8-connected
  components never share a block, so the order is total; it differs from
  plain pixel raster order where two components begin in the same pair of
  rows.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

ELLIPSE_5X5 = np.array([[0, 0, 1, 0, 0],
                        [1, 1, 1, 1, 1],
                        [1, 1, 1, 1, 1],
                        [1, 1, 1, 1, 1],
                        [0, 0, 1, 0, 0]], bool)
EIGHT_CONNECTED = np.ones((3, 3), bool)


def open_ellipse(mask: np.ndarray) -> np.ndarray:
    """cv2.dilate(cv2.erode(m, ellipse), ellipse) of a binary mask."""
    eroded = ndimage.binary_erosion(mask > 0, ELLIPSE_5X5, border_value=1)
    return ndimage.binary_dilation(eroded, ELLIPSE_5X5, border_value=0)


def open_square(mask: np.ndarray, k: int) -> np.ndarray:
    """cv2.morphologyEx(m, MORPH_OPEN, np.ones((k, k))) of a binary mask, as
    uint8 0 / 1: OpenCV anchors both passes at k // 2; scipy reflects the
    structure in the dilation, which moves an even k's window by one, so
    the dilation's origin is -1 there."""
    square = np.ones((k, k), bool)
    eroded = ndimage.binary_erosion(mask > 0, square, border_value=1)
    return ndimage.binary_dilation(eroded, square, border_value=0,
                                   origin=k % 2 - 1).astype(np.uint8)


def label_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """cv2.connectedComponents(mask) (8-connected, labels 1..n in OpenCV's
    block order, 0 background) -> (int labels [H, W], n)."""
    labels, n = ndimage.label(mask > 0, EIGHT_CONNECTED)
    if n == 0:
        return labels, 0
    ys, xs = np.nonzero(labels)
    block = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], block)
    remap = np.zeros(n + 1, labels.dtype)
    remap[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, n + 1)
    return remap[labels], n


def find_connected_components(mask: np.ndarray) -> list[np.ndarray]:
    """Binary [H, W] -> float32 masks of the components of its opening."""
    labels, n = label_components(open_ellipse(mask))
    return [(labels == i).astype(np.float32) for i in range(1, n + 1)]


def cat_to_obj_masks(cat_masks: np.ndarray, max_objects: int):
    """[C, H, W] category masks -> ([O, H, W] float32 object masks, [O]
    int32 category per object, -1 for padding). Objects keep category-major
    order; past ``max_objects`` the smallest are dropped."""
    C, H, W = cat_masks.shape
    objs: list[tuple[float, np.ndarray, int]] = []
    for c in range(C):
        m = (cat_masks[c] > 0).astype(np.float32)
        if m.sum() == 0:
            continue
        for comp in find_connected_components(m):
            objs.append((float(comp.sum()), comp, c))
    if not objs:
        raise ValueError("cat_to_obj_masks: no objects found")
    if len(objs) > max_objects:
        keep = sorted(range(len(objs)), key=lambda i: -objs[i][0])[:max_objects]
        objs = [objs[i] for i in sorted(keep)]
    obj_masks = np.zeros((max_objects, H, W), np.float32)
    obj_to_cat = -np.ones((max_objects,), np.int32)
    for i, (_, m, c) in enumerate(objs):
        obj_masks[i] = m
        obj_to_cat[i] = c
    return obj_masks, obj_to_cat


def center_of_mass(mask: np.ndarray) -> tuple[float, float]:
    ys, xs = np.nonzero(mask)
    return float(ys.mean()), float(xs.mean())


def generate_point_prompt(obj_masks: np.ndarray, num_pos: int, num_neg: int,
                          include_center: bool, rng: np.random.Generator):
    """[O, H, W] -> coords [O, P, 2] (x, y) float32, labels [O, P] int32,
    P = num_pos + num_neg; an all-zero (padding) object keeps label -1."""
    O, H, W = obj_masks.shape
    P = num_pos + num_neg
    coords = np.zeros((O, P, 2), np.float32)
    labels = -np.ones((O, P), np.int32)
    for o in range(O):
        m = obj_masks[o] > 0
        pos_ys, pos_xs = np.nonzero(m)
        if pos_ys.size == 0:
            continue
        pts = []
        if include_center and num_pos > 0:
            cy, cx = center_of_mass(m)
            pts.append((cx, cy))
        need = num_pos - len(pts)
        if need > 0:
            idx = rng.permutation(pos_ys.size)[:need]
            pts.extend(zip(pos_xs[idx].astype(float),
                           pos_ys[idx].astype(float)))
        while len(pts) < num_pos:
            pts.append(pts[0])
        for i, (x, y) in enumerate(pts):
            coords[o, i] = (x, y)
            labels[o, i] = 1
        if num_neg > 0:
            neg_ys, neg_xs = np.nonzero(~m)
            if neg_ys.size > 0:
                idx = rng.permutation(neg_ys.size)[:num_neg]
                for j, k in enumerate(idx):
                    coords[o, num_pos + j] = (float(neg_xs[k]),
                                              float(neg_ys[k]))
                    labels[o, num_pos + j] = 0
    return coords, labels


def sample_box_points(obj_masks: np.ndarray, rng: np.random.Generator,
                      noise: float = 0.1, noise_bound: int = 20):
    """Noised box corners: [O, H, W] -> (coords [O, 2, 2], labels [O, 2]
    with 2 / 3)."""
    O, H, W = obj_masks.shape
    coords = np.zeros((O, 2, 2), np.float32)
    labels = -np.ones((O, 2), np.int32)
    for o in range(O):
        ys, xs = np.nonzero(obj_masks[o] > 0)
        if xs.size == 0:
            continue
        box = np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
        if noise > 0:
            bw, bh = box[2] - box[0], box[3] - box[1]
            max_dx = min(bw * noise, noise_bound)
            max_dy = min(bh * noise, noise_bound)
            jitter = (2 * rng.random(4) - 1) * np.asarray(
                [max_dx, max_dy, max_dx, max_dy])
            box = np.clip(box + jitter, 0,
                          np.asarray([W - 1, H - 1, W - 1, H - 1]))
        coords[o] = box.reshape(2, 2)
        labels[o] = (2, 3)
    return coords, labels


def sample_random_points_from_errors(gt_masks, pred_masks,
                                     rng: np.random.Generator, num_pt=1):
    """Correction clicks drawn uniformly from the false-positive and
    false-negative regions: gt / pred [O, H, W] -> (points [O, num_pt, 2],
    labels [O, num_pt])."""
    gt = np.asarray(gt_masks) > 0
    pred = (np.zeros_like(gt) if pred_masks is None
            else np.asarray(pred_masks) > 0)
    O, H, W = gt.shape
    fp = ~gt & pred
    fn = gt & ~pred
    all_correct = (gt == pred).reshape(O, -1).all(axis=1)
    points = np.zeros((O, num_pt, 2), np.float32)
    labels = np.zeros((O, num_pt), np.int32)
    for o in range(O):
        noise = rng.random((num_pt, H, W, 2))
        neg_region = fp[o] | (all_correct[o] & ~gt[o])
        noise[..., 0] *= neg_region
        noise[..., 1] *= fn[o]
        idx = noise.reshape(num_pt, -1).argmax(axis=1)
        labels[o] = (idx % 2).astype(np.int32)
        pix = idx // 2
        points[o, :, 0] = pix % W
        points[o, :, 1] = pix // W
    return points, labels


def _distance(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, DIST_L2, 0) (exact Euclidean distance to
    the nearest zero pixel), in float32 as OpenCV returns it."""
    if not mask.any():
        return np.zeros(mask.shape, np.float32)
    return ndimage.distance_transform_edt(mask).astype(np.float32)


def sample_one_point_from_error_center(gt_masks, pred_masks, padding=True):
    """A click at the most interior point of the largest error region:
    (points [O, 1, 2], labels [O, 1])."""
    gt = np.asarray(gt_masks) > 0
    pred = (np.zeros_like(gt) if pred_masks is None
            else np.asarray(pred_masks) > 0)
    O, H, W = gt.shape
    points = np.zeros((O, 1, 2), np.float32)
    labels = np.ones((O, 1), np.int32)
    for o in range(O):
        fn = (gt[o] & ~pred[o]).astype(np.uint8)
        fp = (~gt[o] & pred[o]).astype(np.uint8)
        if padding:
            fn = np.pad(fn, 1)
            fp = np.pad(fp, 1)
        fn_dt, fp_dt = _distance(fn), _distance(fp)
        if padding:
            fn_dt = fn_dt[1:-1, 1:-1]
            fp_dt = fp_dt[1:-1, 1:-1]
        fn_flat, fp_flat = fn_dt.reshape(-1), fp_dt.reshape(-1)
        fn_arg, fp_arg = fn_flat.argmax(), fp_flat.argmax()
        is_pos = fn_flat[fn_arg] > fp_flat[fp_arg]
        idx = fn_arg if is_pos else fp_arg
        points[o, 0] = (idx % W, idx // W)
        labels[o, 0] = int(is_pos)
    return points, labels


def get_next_point(gt_masks, pred_masks, method: str,
                   rng: np.random.Generator | None = None):
    """The correction click of ``method`` ("uniform" or "center")."""
    if method == "uniform":
        return sample_random_points_from_errors(
            gt_masks, pred_masks, rng or np.random.default_rng())
    if method == "center":
        return sample_one_point_from_error_center(gt_masks, pred_masks)
    raise ValueError(f"unknown sampling method {method}")


def generate_box_prompt(obj_masks: np.ndarray):
    """[O, H, W] -> box corners [O, 2, 2] (x, y), labels [O, 2] (2, 3)."""
    O = obj_masks.shape[0]
    coords = np.zeros((O, 2, 2), np.float32)
    labels = -np.ones((O, 2), np.int32)
    for o in range(O):
        ys, xs = np.nonzero(obj_masks[o] > 0)
        if xs.size == 0:
            continue
        coords[o, 0] = (float(xs.min()), float(ys.min()))
        coords[o, 1] = (float(xs.max()), float(ys.max()))
        labels[o] = (2, 3)
    return coords, labels
