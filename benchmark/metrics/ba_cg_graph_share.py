"""Share of the PCG camera solves that ran by CUDA graph replay: the
program's counters ``solve_lm.cg_graph_solves`` over
``solve_lm.cg_solves``, read at the end of the run.  None where the
program has no graph counter or ran no PCG solve."""

UNIT = "share"
LAYER = "ba/solver.py _pcg: the joint solve's reduced camera system by PCG"
MOVES = "frames_per_s"


def read(run):
    from sfm_tpu_torch.ba.solver import solve_lm

    solves = getattr(solve_lm, "cg_solves", 0)
    graphed = getattr(solve_lm, "cg_graph_solves", None)
    if not solves or graphed is None:
        return None
    return graphed / solves
