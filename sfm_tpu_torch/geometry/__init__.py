from sfm_tpu_torch.geometry.rotations import (  # noqa: F401
    rodrigues_matrix,
    rodrigues_vector,
    rotate_points,
)
from sfm_tpu_torch.geometry.projection import (  # noqa: F401
    pack_cam,
    project_cam,
    project_pinhole,
    projection_matrix,
    reprojection_errors,
)
from sfm_tpu_torch.geometry.triangulation import (  # noqa: F401
    dehomogenize,
    ray_plane_intersection,
    triangulate_dlt,
)
from sfm_tpu_torch.geometry.epipolar import (  # noqa: F401
    eight_point,
    epipolar_distance,
    sampson_distance,
)
