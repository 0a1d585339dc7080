from sfm_tpu_torch.sfm.ransac import ransac_fundamental  # noqa: F401
from sfm_tpu_torch.sfm.tracks import TrackStore  # noqa: F401
from sfm_tpu_torch.sfm.pipeline import (  # noqa: F401
    SparseReconstruction,
    structure_from_motion,
)
