"""CG iterations per PCG camera solve over the run's process: the
program's counters ``solve_lm.cg_iterations`` over ``solve_lm.cg_solves``
(one solve a joint LM iteration off the dense path), read at the end of
the run.  None where the program has no such counters or ran no PCG
solve."""

UNIT = "iterations"
LAYER = "ba/solver.py _pcg: the joint solve's reduced camera system by PCG"
MOVES = "frames_per_s"


def read(run):
    from sfm_tpu_torch.ba.solver import solve_lm

    solves = getattr(solve_lm, "cg_solves", 0)
    if not solves:
        return None
    return solve_lm.cg_iterations / solves
