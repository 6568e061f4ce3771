"""Hand-written Hopper kernels of the port, each with its plain-torch twin.

``launch_counts`` counts kernel launches per wrapper: a wrapper adds one
where it launches its CUDA kernel and nowhere else (CPU tensors take the
plain version and count nothing), so a caller can show that a run went
through the kernels.
"""
from typing import Dict

launch_counts: Dict[str, int] = {"peel_round": 0, "segment_sum": 0,
                                 "tricount": 0, "flash_attention": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
