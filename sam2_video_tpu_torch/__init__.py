"""PyTorch/CUDA port of sam2_video_tpu: the streaming SAM2 video predictor
with the Hiera block and the memory encoder as hand-written CUDA kernels
for Hopper (sm_90a). Imports torch, never jax.

Entry point: ``VideoPredictor(params_or_state_dict, cfg, device="cuda")``.
"""

from .convert import from_jax_params, load_npz
from .eval.predictor import VideoPredictor
from .models.sam2 import SAM2Config

__all__ = ["VideoPredictor", "SAM2Config", "from_jax_params", "load_npz"]
