"""SAM2 modules, mirroring ``sam2_video_tpu/models``."""
