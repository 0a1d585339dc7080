from sfm_tpu_torch.io.calib import Calibration, read_pars, write_pars  # noqa: F401
from sfm_tpu_torch.io.images import gray_tensor, load_images, to_gray  # noqa: F401
from sfm_tpu_torch.io.ply import export_ply, read_ply  # noqa: F401
