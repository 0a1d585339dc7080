from sfm_tpu_torch.ops.harris import detect_corners, harris_response  # noqa: F401
from sfm_tpu_torch.ops.gray import rgb_to_gray  # noqa: F401
from sfm_tpu_torch.ops.gather import sample_normalized_patches  # noqa: F401
from sfm_tpu_torch.ops.patches import extract_patches, normalize_descriptors  # noqa: F401
from sfm_tpu_torch.ops.ncc import ncc_scores  # noqa: F401
