"""SuperPoint (BN and VGG), SuperGlue and their Matching composition, and
the registry that names them (the JAX package's `models.MODEL_REGISTRY`
and `get_model`)."""
from image_matching_tpu_torch.models.matching import Matching, MatchingConfig
from image_matching_tpu_torch.models.superglue import SuperGlue
from image_matching_tpu_torch.models.superpoint import SuperPointBN, SuperPointVGG

MODEL_REGISTRY = {
    "superpoint_bn": SuperPointBN,
    "superpoint_vgg": SuperPointVGG,
    "superglue": SuperGlue,
}


def get_model(name: str, **kwargs):
    """The model registered as `name`, built with `kwargs`."""
    return MODEL_REGISTRY[name](**kwargs)


__all__ = ["Matching", "MatchingConfig", "SuperGlue", "SuperPointBN", "SuperPointVGG", "get_model",
           "MODEL_REGISTRY"]
