"""The port's config engine (``sam2_video_tpu_torch/config.py``) held
against the JAX package's: its YAML copies byte for byte, the resolved
trees of each base config, group selection and dotted override of
``tests/test_config.py``, and the typed model and loss configs field by
field."""

import dataclasses
from pathlib import Path

import pytest

from sam2_video_tpu import config as jconfig
from sam2_video_tpu_torch import config as tconfig

PORTED = ["best.yaml", "config.yaml", "data/cholecseg8k.yaml",
          "data/endovis17.yaml", "data/endovis18.yaml",
          "eval_pipeline_test.yaml", "losses/dice_main.yaml",
          "losses/equal.yaml", "losses/focal_main.yaml",
          "memory_overfit.yaml", "overfit.yaml"]
# the combo selections (configs/combo/<dataset>/<n>.yaml), as many as the
# JAX package has
COMBOS = sorted(str(p.relative_to(jconfig.CONFIG_DIR))
                for p in jconfig.CONFIG_DIR.glob("combo/*/*.yaml"))
BASES = ["config", "best", "overfit", "memory_overfit", "eval_pipeline_test"]
OVERRIDES = [
    [], ["data=endovis17"], ["data=endovis18", "model.prompt_type=mask"],
    ["loss=dice_main"], ["loss=focal_main", "loss=equal"],
    ["optimizer.lr=5e-5", "model.prompt_type=mask", "trainer.max_epochs=1",
     "loss.weight_dict.loss_iou=3"],
    ["model.prompt_type=box", "model.num_pos_points=3"],
    ["trainer.limit_train_batches=2", "device=cpu", "new.key.deep=[1, 2]",
     "optimizer.betas=[0.8, 0.9]", "scheduler.enabled=false"],
]


# the lines where config.yaml's copy differs: the original names the
# reference repository by a path on the machine it was written on (6) and
# the JAX package's converter command, where the copy names the port's (15)
CONFIG_YAML_LINE = 6
CONVERTER_LINE = 15


def test_yaml_copies_are_byte_equal():
    """Every copy byte for byte (the combo files too), but config.yaml's
    comment lines CONFIG_YAML_LINE, which names the reference without a
    machine path, and CONVERTER_LINE, which names the port's converter
    command (``python -m sam2_video_tpu_torch.training.convert``; the
    card's machine has no JAX)."""
    ours = sorted(str(p.relative_to(tconfig.CONFIG_DIR))
                  for p in tconfig.CONFIG_DIR.rglob("*.yaml"))
    assert COMBOS and ours == sorted(PORTED + COMBOS)
    for name in PORTED + COMBOS:
        got = (tconfig.CONFIG_DIR / name).read_bytes()
        want = (jconfig.CONFIG_DIR / name).read_bytes()
        if name == "config.yaml":
            got, want = got.splitlines(True), want.splitlines(True)
            assert len(got) == len(want)
            diff = [i + 1 for i, (a, b) in enumerate(zip(got, want))
                    if a != b]
            assert diff == [CONFIG_YAML_LINE, CONVERTER_LINE]
            assert got[CONFIG_YAML_LINE - 1].startswith(b"# ")
            assert got[CONVERTER_LINE - 1] == want[CONVERTER_LINE - 1].replace(
                b"sam2_video_tpu.", b"sam2_video_tpu_torch.")
        else:
            assert got == want, name


@pytest.mark.parametrize("base", BASES)
def test_load_config_matches_jax(base):
    for ov in OVERRIDES:
        got = tconfig.load_config(base, list(ov))
        want = jconfig.load_config(base, list(ov))
        assert got == want, (base, ov)
        assert type(got.trainer) is tconfig.Config
    assert (tconfig.load_config("config", ["model.prompt_type=box"])
            .eval.prompt_type == "box")
    with pytest.raises(ValueError, match="key=value"):
        tconfig.load_config(base, ["trainer.max_epochs"])


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("base", BASES)
def test_typed_configs_match_jax(base):
    """model_config / loss_config: every field the JAX config sets from the
    tree has the same value in the port's (the SAM2 config by name; the
    loss config field for field)."""
    for ov in OVERRIDES[:4]:
        cfg = jconfig.load_config(base, list(ov))
        jm, tm = jconfig.model_config(cfg), tconfig.model_config(cfg)
        assert tm.prompt_type == jm.prompt_type
        jf, tf = _fields(jm.sam2), _fields(tm.sam2)
        shared = set(jf) & set(tf)
        assert {"image_size", "use_activation_checkpoint", "remat_mode",
                "compute_dtype", "num_maskmem", "use_flash_attention",
                "scan_unroll", "detach_memory_bank"} <= shared
        assert {k: tf[k] for k in shared} == {k: jf[k] for k in shared}
        assert _fields(tconfig.loss_config(cfg)).items() >= {
            k: v for k, v in _fields(jconfig.loss_config(cfg)).items()
        }.items()


def test_config_dir_argument(tmp_path):
    """A config directory of one's own, as with the JAX engine."""
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "a.yaml").write_text("image_size: 7\n")
    (tmp_path / "top.yaml").write_text(
        "defaults:\n  - data: a\n  - _self_\nx: ${data.image_size}\n")
    got = tconfig.load_config("top", ["data.image_size=9"], tmp_path)
    assert got == jconfig.load_config("top", ["data.image_size=9"], tmp_path)
    assert got.x == 9 and Path(tmp_path).is_dir()
