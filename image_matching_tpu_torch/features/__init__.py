"""Classical features: SIFT and ORB, and their registration pipelines."""
from image_matching_tpu_torch.features.orb import ORBConfig, orb_detect_and_describe
from image_matching_tpu_torch.features.sift import SIFTConfig, sift_detect_and_describe

__all__ = [
    "SIFTConfig",
    "sift_detect_and_describe",
    "ORBConfig",
    "orb_detect_and_describe",
]
