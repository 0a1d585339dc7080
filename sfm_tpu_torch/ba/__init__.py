from sfm_tpu_torch.ba.problem import BAProblem, build_problem  # noqa: F401
from sfm_tpu_torch.ba.model import residuals, total_cost, jacobian_blocks  # noqa: F401
from sfm_tpu_torch.ba.solver import solve_lm  # noqa: F401
from sfm_tpu_torch.ba.run import bundle_adjust  # noqa: F401
