from sfm_tpu_torch.utils.metrics import Metrics, StageTimer  # noqa: F401
