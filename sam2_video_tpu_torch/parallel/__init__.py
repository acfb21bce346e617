"""Data parallelism on ``torch.distributed`` (counterpart of
``sam2_video_tpu/parallel/``)."""
