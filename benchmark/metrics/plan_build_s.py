"""plan_build_s: host seconds of the program's builders in set-up (the
OD or lattice builders' static plans, the TUD composition, the banded
reduction operator)."""


def read(run):
    return run.plan_build_s
