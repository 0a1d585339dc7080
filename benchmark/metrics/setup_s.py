"""Set-up: from the process's start to the window's (interpreter and
library imports, the program's libraries, the CUDA context, the scene,
the first reconstruction and the warm-up passes)."""

UNIT = "s"


def read(run):
    return run.setup_s
