"""SuperPoint (BN and VGG), SuperGlue and their Matching composition."""
from image_matching_tpu_torch.models.matching import Matching, MatchingConfig
from image_matching_tpu_torch.models.superglue import SuperGlue
from image_matching_tpu_torch.models.superpoint import SuperPointBN, SuperPointVGG

__all__ = ["Matching", "MatchingConfig", "SuperGlue", "SuperPointBN", "SuperPointVGG"]
