"""Generate the experiment combo YAMLs under
sam2_video_tpu_torch/configs/combo/<dataset>/, the PyTorch/CUDA port's
config tree (the counterpart of ``generate_combo_yamls.py``, which writes
the JAX package's tree; the same CLI and the same files).

Parity spec: the reference repository's generate_combo_yamls.py and its
combo tree (configs/combo/<ds>/{1..21}.yaml): 21 combos per dataset = prompt type
{point, box, mask} x trainable-module set {mem, mem+md, md, md+pe, md+pe+ie,
mem+md+pe, mem+md+pe+ie}; optionally also the ``<n>_mem`` / ``<n>_mem_sfx``
fine-tuned-checkpoint variants when an eval_list.md of checkpoint paths is
supplied (reference :50-162).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parent
OUT_ROOT = REPO / "sam2_video_tpu_torch" / "configs" / "combo"

DATASETS = ["cholecseg8k", "endovis17", "endovis18"]
PROMPTS = ["point", "box", "mask"]
# the 7 module sets in the reference's combo numbering order (per prompt):
MODULE_SETS = [
    ("mem", ["memory_encoder", "memory_attention"]),
    ("mem+md", ["memory_encoder", "memory_attention", "mask_decoder"]),
    ("md", ["mask_decoder"]),
    ("md+pe", ["mask_decoder", "prompt_encoder"]),
    ("md+pe+ie", ["mask_decoder", "prompt_encoder", "image_encoder"]),
    ("mem+md+pe", ["memory_encoder", "memory_attention", "mask_decoder",
                   "prompt_encoder"]),
    ("mem+md+pe+ie", ["memory_encoder", "memory_attention", "mask_decoder",
                      "prompt_encoder", "image_encoder"]),
]


def combo_doc(dataset: str, prompt: str, set_name: str, modules: list,
              finetuned: str | None = None) -> str:
    doc = {
        "defaults": [f"/data/{dataset}@data"],
        "model": {
            "fintuned_model_path": finetuned,
            "trainable_modules": list(modules),
            "prompt_type": prompt,
        },
        "combo": {"name": f"{dataset}_{prompt}_{set_name}"},
    }
    return "# @package _global_\n\n" + yaml.safe_dump(doc, sort_keys=False)


# The exact reference combo numbering (verified against
# configs/combo/endovis18/{1..21}.yaml combo.name fields):
_REFERENCE_TABLE = [
    ("point", "mem"), ("point", "mem+md"), ("point", "mem+md+pe"),      # 1-3
    ("box", "mem"), ("box", "mem+md"), ("box", "mem+md+pe"),            # 4-6
    ("mask", "mem"), ("mask", "mem+md"), ("mask", "mem+md+pe"),         # 7-9
    ("point", "md"), ("point", "md+pe"),                                # 10-11
    ("box", "md"), ("box", "md+pe"),                                    # 12-13
    ("mask", "md"), ("mask", "md+pe"), ("mask", "md+pe+ie"),            # 14-16
    ("point", "mem+md+pe+ie"), ("box", "mem+md+pe+ie"),                 # 17-18
    ("mask", "mem+md+pe+ie"),                                           # 19
    ("point", "md+pe+ie"), ("box", "md+pe+ie"),                         # 20-21
]

_SET_BY_NAME = dict(MODULE_SETS)


def generate(datasets=DATASETS):
    count = 0
    for ds in datasets:
        out_dir = OUT_ROOT / ds
        out_dir.mkdir(parents=True, exist_ok=True)
        for idx, (prompt, set_name) in enumerate(_REFERENCE_TABLE, start=1):
            (out_dir / f"{idx}.yaml").write_text(
                combo_doc(ds, prompt, set_name, _SET_BY_NAME[set_name]))
            count += 1
    print(f"wrote {count} combo configs under {OUT_ROOT}")


def infer_from_path(path: str):
    """'.../cholecseg8k_point_pe/cholecseg8k_point_pe_10.torch' ->
    (dataset, prompt_type, suffix) (reference :50-80)."""
    parent = Path(path).parent.name
    tokens = parent.split("_")
    dataset = tokens[0] if tokens else "unknown"
    prompt = {"point": "point", "bbox": "box", "box": "box",
              "mask": "mask"}.get(tokens[1] if len(tokens) > 1 else "point",
                                  "point")
    suffix = tokens[2] if len(tokens) > 2 else ""
    if suffix not in ("pe", "all"):
        suffix = ""
    return dataset, prompt, suffix


def generate_from_eval_list(eval_list_path: str):
    """Finetuned-checkpoint combo variants (reference :82-162):
    <n>_mem (memory modules), <n>_sfx (decoder[/+pe]), <n>_mem_sfx (union)."""
    lines = Path(eval_list_path).read_text().splitlines()
    paths = [l[1:].strip() for l in lines
             if l.strip().startswith("-") and l[1:].strip()]
    count = 0
    for idx, ckpt in enumerate(paths, start=1):
        dataset, prompt, suffix = infer_from_path(ckpt)
        sfx_modules = ["mask_decoder"]
        if suffix in ("pe", "all"):
            sfx_modules.append("prompt_encoder")
        mem_modules = ["memory_encoder", "memory_attention"]
        variants = {
            f"{idx}_mem": mem_modules,
            f"{idx}_sfx": sfx_modules,
            f"{idx}_mem_sfx": mem_modules + sfx_modules,
        }
        out_dir = OUT_ROOT / dataset
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, modules in variants.items():
            set_name = name.split("_", 1)[1]
            (out_dir / f"{name}.yaml").write_text(
                combo_doc(dataset, prompt, set_name, modules,
                          finetuned=ckpt))
            count += 1
    print(f"wrote {count} finetuned combo variants from {eval_list_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datasets", nargs="*", default=DATASETS)
    ap.add_argument("--eval-list", default=None,
                    help="eval_list.md of checkpoint paths -> finetuned "
                         "combo variants (<n>_mem / <n>_sfx / <n>_mem_sfx)")
    args = ap.parse_args(argv)
    generate(args.datasets)
    if args.eval_list:
        generate_from_eval_list(args.eval_list)


if __name__ == "__main__":
    main()
