"""Prompt-driven video-propagation inference over a COCO dataset
(counterpart of ``sam2_video_tpu/eval/inference.py``, reference
inference.py): clips scheduled by a fixed ``clip_length`` (:657-703) or by
a change in the categories present (``variable_cats``, :598-767, the two
merged); per clip, prompts taken from the ground truth (connected
components -> point, box or mask prompts, :275-326, with optional noise),
propagation in reverse and then forward, the forward pass overwriting
(:487-515); masks OR-merged per category under ``obj_id = OBJ_COUNT * MOD
+ category_id`` (:300, :873-885); float16 probability dumps (:450-485);
``predict.json`` and ``prompt.pkl`` (:844-915).

An ``InferenceRunner`` holds the predictor and the dataset; frames are
read once per clip on the host (PNG or JPEG, ``data/image_io.py``, the
same pixels as the JAX package's OpenCV or Pillow) and encoded on
the device. With ``batch_videos`` G > 1 the runner first schedules every
video's clips and extracts their prompts (resetting the object count per
video), then tracks each full group of G clips that share length,
resolution and prompt frame in lockstep (``eval/batched_predictor.py``);
the clips that fill no group run one after another on the sequential
predictor. The prompt noise is then drawn group by group, video by video
and object by object, then for the leftover clips, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data import image_io
from ..data import rle as rle_mod
from ..models.sam2 import SAM2Config
from .batched_predictor import BatchedVideoPredictor
from .noise import PromptObjNoiseAdder
from .predictor import VideoPredictor, logits_to_orig
from .utils import (ClipRange, PromptInfo, PromptObj, init_grid, mask_to_bbox,
                    mask_to_masks, mask_to_points)

DECODE_THREADS = 8


@dataclasses.dataclass
class InferenceConfig:
    prompt_type: str = "points"        # points | bbox | mask
    clip_length: int | None = None
    variable_cats: bool = False
    num_points: int = 1
    num_neg_points: int = 0
    include_center: bool = True
    noised_prompt: bool = False
    noise_intensity: float = 0.1
    bbox_noise_type: str = "shift_scale"
    grid_spacing: int | None = None
    max_objects: int = 8
    seed: int = 0
    # >1: that many same-shape clips tracked in lockstep per device step
    # (BatchedVideoPredictor); clips that fill no group run sequentially
    batch_videos: int = 1
    # conditioning slots of the predictor; raise it for clips that prompt
    # more than one frame
    max_cond_frames: int = 1


_NORMALIZE_PROMPT = {"point": "points", "box": "bbox", "mask": "mask",
                     "points": "points", "bbox": "bbox"}


class _CocoView:
    """Light view over a raw COCO JSON for eval (original resolution)."""

    def __init__(self, coco_path):
        data = json.loads(Path(coco_path).read_text())
        self.images = data["images"]
        self.categories = data["categories"]
        self.anns_by_image: dict = {}
        for ann in data["annotations"]:
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.mod = max(c["id"] for c in self.categories) + 1
        self.video_ids = sorted({im["video_id"] for im in self.images},
                                key=str)
        self.frames_by_video: dict = {}
        for im in self.images:
            self.frames_by_video.setdefault(im["video_id"], []).append(im)
        for frames in self.frames_by_video.values():
            frames.sort(key=lambda f: f.get("order_in_video", 0))

    def frames_of(self, video_id):
        return self.frames_by_video.get(video_id, [])

    def anns(self, image_id):
        return self.anns_by_image.get(image_id, [])


class InferenceRunner:
    def __init__(self, params, sam2_cfg: SAM2Config, cfg: InferenceConfig,
                 coco_path, eval_dir, image_root: str | None = None,
                 device: str | torch.device = "cuda"):
        self.coco = _CocoView(coco_path)
        self.cfg = cfg
        self.eval_dir = Path(eval_dir)
        self.eval_dir.mkdir(parents=True, exist_ok=True)
        self.image_root = image_root
        self.predictor = VideoPredictor(params, sam2_cfg,
                                        max_objects=cfg.max_objects,
                                        max_cond_frames=cfg.max_cond_frames,
                                        device=device)
        self._batched_pred = None
        self.obj_count = 0
        self.prompt_info: list[PromptInfo] = []
        self.rng = np.random.default_rng(cfg.seed)
        self.noise = (PromptObjNoiseAdder(cfg.bbox_noise_type,
                                          cfg.noise_intensity)
                      if cfg.noised_prompt else None)
        if cfg.grid_spacing is not None and self.coco.images:
            init_grid((self.coco.images[0]["height"],
                       self.coco.images[0]["width"]), cfg.grid_spacing)

    # -- prompt extraction --------------------------------------------------

    def _get_each_obj(self, frame) -> list[PromptObj]:
        objs = []
        for ann in self.coco.anns(frame["id"]):
            raw = rle_mod.decode(ann["segmentation"])
            for mask in mask_to_masks(raw):
                obj_id = self.obj_count * self.coco.mod + ann["category_id"]
                pos = mask_to_points(mask, self.cfg.num_points,
                                     self.cfg.include_center, self.rng)
                neg = mask_to_points(np.logical_not(mask),
                                     self.cfg.num_neg_points, False, self.rng)
                objs.append(PromptObj(
                    mask=mask, bbox=mask_to_bbox(mask),
                    points=np.concatenate([pos, neg]) if len(neg) else pos,
                    obj_id=obj_id,
                    pos_or_neg_label=np.concatenate(
                        [np.ones(len(pos)), np.zeros(len(neg))])))
                self.obj_count += 1
        return objs

    def _find_prompt_frame(self, frames, clip_range: ClipRange):
        for frame in frames:
            if not frame.get("is_det_keyframe", True):
                continue
            o = frame["order_in_video"]
            if o < clip_range.start_idx or o > clip_range.end_idx:
                continue
            if self.coco.anns(frame["id"]):
                return frame
        return None

    # -- clip scheduling (reference inference.py:598-767) -------------------

    def _prompts_by_clip_length(self, frames, prompt_type, clip_length):
        if clip_length is None:
            clip_length = len(frames)
        cur_start, cur_end, cur_prompts = 0, -1, []
        for start in range(0, len(frames), clip_length):
            end = min(start + clip_length - 1, len(frames) - 1)
            pf = self._find_prompt_frame(frames, ClipRange(start, end))
            if pf is None:
                cur_end = end
                continue
            if cur_start <= cur_end:
                for p in cur_prompts:
                    p.clip_range = ClipRange(cur_start, cur_end)
                yield cur_prompts, ClipRange(cur_start, cur_end)
                cur_prompts = []
            cur_prompts.append(PromptInfo(
                prompt_objs=self._get_each_obj(pf),
                frame_idx=pf["order_in_video"], prompt_type=prompt_type,
                video_id=str(pf["video_id"]), path=pf.get("path", ""),
                clip_range=None))
            cur_start, cur_end = start, end
        if cur_start <= cur_end:
            for p in cur_prompts:
                p.clip_range = ClipRange(cur_start, cur_end)
            yield cur_prompts, ClipRange(cur_start, cur_end)

    def _prompts_by_categories(self, frames, prompt_type):
        existing: set = set()
        prev_info, prev_start = None, None
        out = []
        for frame in frames:
            if not frame.get("is_det_keyframe", True):
                continue
            cats = {a["category_id"] for a in self.coco.anns(frame["id"])}
            if cats.issubset(existing):
                continue
            existing |= cats
            info = PromptInfo(
                prompt_objs=self._get_each_obj(frame),
                frame_idx=frame["order_in_video"], prompt_type=prompt_type,
                video_id=str(frame["video_id"]), path=frame.get("path", ""),
                clip_range=None)
            if prev_info is None:
                prev_info, prev_start = info, info.frame_idx
                continue
            prev_info.clip_range = ClipRange(prev_start, info.frame_idx - 1)
            out.append(([prev_info], ClipRange(prev_start,
                                               info.frame_idx - 1)))
            prev_info, prev_start = info, info.frame_idx
        if prev_info is not None and prev_start != len(frames) - 1:
            prev_info.clip_range = ClipRange(prev_start, len(frames) - 1)
            out.append(([prev_info], ClipRange(prev_start, len(frames) - 1)))
        return out

    def _merge_prompts(self, by_cats, by_len):
        range_dict = {}
        for info, cr in list(by_cats) + list(by_len):
            range_dict[cr.start_idx] = (info, cr)
        all_ranges = sorted(range_dict.values(), key=lambda x: x[1].start_idx)
        merged, cur_start, cur_end, cur = [], None, None, []
        for info, cr in all_ranges:
            if cur_start is None:
                cur_start, cur_end, cur = cr.start_idx, cr.end_idx, info
            elif cr.start_idx < cur_end:
                for p in cur:
                    p.clip_range = ClipRange(cur_start, cr.start_idx - 1)
                merged.append((cur, ClipRange(cur_start, cr.start_idx - 1)))
                cur_start, cur_end, cur = cr.start_idx, cr.end_idx, info
            else:
                for p in cur:
                    p.clip_range = ClipRange(cur_start, cur_end)
                merged.append((cur, ClipRange(cur_start, cur_end)))
                cur_start, cur_end, cur = cr.start_idx, cr.end_idx, info
        if cur_start is not None:
            for p in cur:
                p.clip_range = ClipRange(cur_start, cur_end)
            merged.append((cur, ClipRange(cur_start, cur_end)))
        return merged

    # -- per-clip processing ------------------------------------------------

    def _load_frames(self, frames_info) -> np.ndarray:
        """A clip's frames as uint8 [T, H, W, 3], PNG or JPEG, read in
        threads (zlib and the C++ helpers release the interpreter lock)
        with the bits of the JAX package's reader, OpenCV's ``imread``
        (``image_io.read_rgb(..., reader="opencv")``: it differs from
        the training pipeline's Pillow bits on CMYK / YCCK JPEG and 16-bit
        grey PNG). EXIF orientation is not applied, as the JAX package's
        reader does not apply it."""
        def resolve(f):
            path = f.get("path") or f["file_name"]
            if self.image_root is not None:
                cand = Path(self.image_root) / f.get("file_name",
                                                     Path(path).name)
                if cand.exists():
                    path = str(cand)
            return path

        def read(path):
            return image_io.read_rgb(path, reader="opencv")

        paths = [resolve(f) for f in frames_info]
        if len(paths) == 1:
            return read(paths[0])[None]
        with ThreadPoolExecutor(min(DECODE_THREADS, len(paths))) as pool:
            return np.stack(list(pool.map(read, paths)))

    def _process_clip(self, frames, clip_prompts, clip_range: ClipRange,
                      probs_out_dir=None):
        start, end = clip_range.start_idx, clip_range.end_idx
        clip_frames = frames[start: end + 1]
        pixels = self._load_frames(clip_frames)
        state = self.predictor.init_state(pixels)

        for prompt_info in clip_prompts:
            rel = prompt_info.frame_idx - start
            for obj in prompt_info.prompt_objs:
                if self.noise is not None:
                    obj = self.noise.add_noise_to_obj(
                        obj, prompt_info.prompt_type)
                    if obj is None:
                        continue
                if prompt_info.prompt_type == "points":
                    self.predictor.add_new_points_or_box(
                        state, rel, obj.obj_id, points=obj.points,
                        labels=obj.pos_or_neg_label)
                elif prompt_info.prompt_type == "bbox":
                    self.predictor.add_new_points_or_box(
                        state, rel, obj.obj_id, box=obj.bbox)
                else:
                    self.predictor.add_new_mask(state, rel, obj.obj_id,
                                                obj.mask)

        video_segments = {}
        want_probs = probs_out_dir is not None
        for reverse in (True, False):
            for rel_idx, obj_ids, logits, score in \
                    self.predictor.propagate_in_video(state, reverse=reverse):
                mask, probs = logits_to_orig(logits, state.orig_hw,
                                             want_probs=want_probs)
                if want_probs:
                    self._maybe_write_probs(probs_out_dir,
                                            clip_frames[rel_idx], obj_ids,
                                            probs)
                video_segments[rel_idx + start] = {
                    oid: {"mask": mask[i], "score": float(score[i])}
                    for i, oid in enumerate(obj_ids)}
        return video_segments

    def _maybe_write_probs(self, probs_out_dir, frame, obj_ids, probs):
        out = Path(probs_out_dir)
        out.mkdir(parents=True, exist_ok=True)
        npz = out / f"{frame['id']}.npz"
        if npz.exists() or len(obj_ids) == 0:
            return
        np.savez_compressed(
            npz, probs=np.squeeze(np.asarray(probs, np.float16), axis=1),
            obj_ids=np.asarray(obj_ids, np.int64),
            image_id=np.int64(frame["id"]),
            video_id=str(frame["video_id"]),
            order_in_video=np.int64(frame["order_in_video"]),
            height=np.int32(frame["height"]), width=np.int32(frame["width"]))

    # -- top-level ----------------------------------------------------------

    def process_video(self, video_id, probs_out_dir=None):
        self.obj_count = 0
        frames = self.coco.frames_of(video_id)
        prompt_type = _NORMALIZE_PROMPT[self.cfg.prompt_type]
        if self.cfg.variable_cats:
            gen = self._merge_prompts(
                self._prompts_by_categories(frames, prompt_type),
                self._prompts_by_clip_length(frames, prompt_type,
                                             self.cfg.clip_length))
        else:
            gen = self._prompts_by_clip_length(frames, prompt_type,
                                               self.cfg.clip_length)
        video_segments = {}
        for clip_prompts, clip_range in gen:
            self.prompt_info.extend(clip_prompts)
            video_segments.update(self._process_clip(
                frames, clip_prompts, clip_range, probs_out_dir))
        return video_segments

    # -- grouped (lockstep) processing --------------------------------------

    def _collect_clip_jobs(self):
        """Every video's clip schedule and prompts, as ``process_video``
        makes them (the object count reset per video), as one list of
        (video_id, frames, clip_prompts, clip_range) jobs."""
        prompt_type = _NORMALIZE_PROMPT[self.cfg.prompt_type]
        jobs = []
        for video_id in self.coco.video_ids:
            self.obj_count = 0
            frames = self.coco.frames_of(video_id)
            if self.cfg.variable_cats:
                gen = self._merge_prompts(
                    self._prompts_by_categories(frames, prompt_type),
                    self._prompts_by_clip_length(frames, prompt_type,
                                                 self.cfg.clip_length))
            else:
                gen = self._prompts_by_clip_length(frames, prompt_type,
                                                   self.cfg.clip_length)
            for clip_prompts, clip_range in gen:
                self.prompt_info.extend(clip_prompts)
                jobs.append((video_id, frames, clip_prompts, clip_range))
        return jobs

    def _job_group_key(self, job):
        """Clips group together when they share length, prompt frame
        (relative to the clip) and resolution; a clip prompted on several
        frames, or with no object or more than max_objects, groups with
        none (None)."""
        _, frames, clip_prompts, cr = job
        if len(clip_prompts) != 1:
            return None
        if not 0 < len(clip_prompts[0].prompt_objs) <= self.cfg.max_objects:
            return None
        f0 = frames[0]
        return (cr.end_idx - cr.start_idx + 1,
                clip_prompts[0].frame_idx - cr.start_idx,
                f0["height"], f0["width"])

    def _process_group(self, jobs, all_segments, probs_out_dir):
        """One full group of clips through the BatchedVideoPredictor,
        reverse and then forward."""
        G = len(jobs)
        if self._batched_pred is None or self._batched_pred.group_size != G:
            self._batched_pred = BatchedVideoPredictor(
                self.predictor.params, self.predictor.cfg,
                max_objects=self.cfg.max_objects, group_size=G,
                device=self.predictor.device)
        pred = self._batched_pred
        clip_frames = [frames[cr.start_idx: cr.end_idx + 1]
                       for _, frames, _, cr in jobs]
        state = pred.init_group(np.stack([self._load_frames(cf)
                                          for cf in clip_frames]))
        for g, (_, _, clip_prompts, cr) in enumerate(jobs):
            info = clip_prompts[0]
            rel = info.frame_idx - cr.start_idx
            for obj in info.prompt_objs:
                if self.noise is not None:
                    obj = self.noise.add_noise_to_obj(obj, info.prompt_type)
                    if obj is None:
                        continue
                if info.prompt_type == "points":
                    pred.add_new_points_or_box(state, g, rel, obj.obj_id,
                                               points=obj.points,
                                               labels=obj.pos_or_neg_label)
                elif info.prompt_type == "bbox":
                    pred.add_new_points_or_box(state, g, rel, obj.obj_id,
                                               box=obj.bbox)
                else:
                    pred.add_new_mask(state, g, rel, obj.obj_id, obj.mask)

        want_probs = probs_out_dir is not None
        for reverse in (True, False):
            for rel_idx, obj_ids, logits, score in \
                    pred.propagate_in_group(state, reverse=reverse):
                for g, (video_id, _, _, cr) in enumerate(jobs):
                    n = len(obj_ids[g])
                    mask, probs = logits_to_orig(logits[g, :n],
                                                 state.orig_hw,
                                                 want_probs=want_probs)
                    if want_probs:
                        self._maybe_write_probs(probs_out_dir,
                                                clip_frames[g][rel_idx],
                                                obj_ids[g], probs)
                    all_segments.setdefault(video_id, {})[
                        rel_idx + cr.start_idx] = {
                        oid: {"mask": mask[i], "score": float(score[g, i])}
                        for i, oid in enumerate(obj_ids[g])}

    def _run_grouped(self, probs_out_dir):
        """Every full group of ``batch_videos`` clips in lockstep, in the
        order of their keys' first clips, then the clips left over one by
        one."""
        groups: dict = {}
        leftovers = []
        for job in self._collect_clip_jobs():
            key = self._job_group_key(job)
            if key is None:
                leftovers.append(job)
            else:
                groups.setdefault(key, []).append(job)
        all_segments: dict = {}
        G = self.cfg.batch_videos
        for members in groups.values():
            for i in range(0, len(members), G):
                chunk = members[i: i + G]
                if len(chunk) == G:
                    self._process_group(chunk, all_segments, probs_out_dir)
                else:
                    leftovers.extend(chunk)
        for video_id, frames, clip_prompts, cr in leftovers:
            all_segments.setdefault(video_id, {}).update(
                self._process_clip(frames, clip_prompts, cr, probs_out_dir))
        for video_id in self.coco.video_ids:
            all_segments.setdefault(video_id, {})
        return all_segments

    def run(self, save_video_list=None, probs_out_dir=None):
        if probs_out_dir is not None and not Path(probs_out_dir).is_absolute():
            probs_out_dir = self.eval_dir / probs_out_dir
        if self.cfg.batch_videos > 1:
            all_segments = self._run_grouped(probs_out_dir)
        else:
            all_segments = {video_id: self.process_video(video_id,
                                                         probs_out_dir)
                            for video_id in self.coco.video_ids}
        predict_path, prompt_path = self.save_as_coco_format(
            all_segments, save_video_list)
        if probs_out_dir is not None:
            image_ids = [int(p.stem) if p.stem.isdigit() else p.stem
                         for p in Path(probs_out_dir).glob("*.npz")]
            (Path(probs_out_dir) / "meta.json").write_text(json.dumps(
                {"mod": int(self.coco.mod), "image_ids": image_ids,
                 "dtype": "float16"}, indent=2))
        return predict_path, prompt_path

    def save_as_coco_format(self, all_segments, save_video_list=None):
        coco_annotations = []
        videos = save_video_list or self.coco.video_ids
        unknown = [v for v in videos if v not in all_segments]
        if unknown:
            src = "save_video_list entries" if save_video_list else "videos"
            raise ValueError(
                f"{src} with no processed results: {unknown}; "
                f"known video ids: {sorted(all_segments, key=str)}")
        for video_id in videos:
            segments = all_segments[video_id]
            for frame in self.coco.frames_of(video_id):
                seg = segments.get(frame["order_in_video"], {})
                merged, scores = {}, {}
                for key, info in seg.items():
                    remainder = key % self.coco.mod
                    m = np.logical_or.reduce(info["mask"], axis=0)
                    scores[remainder] = info["score"]
                    merged[remainder] = (m if remainder not in merged
                                         else np.logical_or(merged[remainder],
                                                            m))
                for cat, mask in merged.items():
                    if mask.sum() == 0:
                        continue
                    r = rle_mod.encode(mask.astype(np.uint8))
                    coco_annotations.append({
                        "image_id": frame["id"], "category_id": int(cat),
                        "segmentation": r,
                        "bbox": mask_to_bbox(mask), "iscrowd": 0,
                        "score": scores[cat]})
        predict_path = self.eval_dir / "predict.json"
        prompt_path = self.eval_dir / "prompt.pkl"
        predict_path.write_text(json.dumps(coco_annotations, indent=4))
        with open(prompt_path, "wb") as f:
            pickle.dump(self.prompt_info, f)
        return str(predict_path), str(prompt_path)


def inference(params, sam2_cfg: SAM2Config, coco_path, run_dir,
              prompt_type="points", save_video_list=None, clip_length=None,
              variable_cats=False, num_points=1, include_center=True,
              noised_prompt=False, noise_intensity=0.1,
              bbox_noise_type="shift_scale", num_neg_points=0,
              grid_spacing=None, probs_out_dir=None, max_objects=8,
              image_root=None, seed=0, batch_videos=1, max_cond_frames=1,
              device: str | torch.device = "cuda"):
    """The reference's inference() (:919-1084): writes
    ``<run_dir>/eval/predict.json`` and ``prompt.pkl`` (and the probability
    maps under ``probs_out_dir``) and returns their paths."""
    cfg = InferenceConfig(
        prompt_type=prompt_type, clip_length=clip_length,
        variable_cats=variable_cats, num_points=num_points,
        num_neg_points=num_neg_points, include_center=include_center,
        noised_prompt=noised_prompt, noise_intensity=noise_intensity,
        bbox_noise_type=bbox_noise_type, grid_spacing=grid_spacing,
        max_objects=max_objects, seed=seed, batch_videos=batch_videos,
        max_cond_frames=max_cond_frames)
    eval_dir = Path(run_dir) / "eval"
    runner = InferenceRunner(params, sam2_cfg, cfg, coco_path, eval_dir,
                             image_root=image_root, device=device)
    return runner.run(save_video_list=save_video_list,
                      probs_out_dir=probs_out_dir)
