from sfm_tpu_torch.features.frontend import FeatureSet, detect_and_describe  # noqa: F401
from sfm_tpu_torch.features.matching import MatchResult, match_descriptors  # noqa: F401
