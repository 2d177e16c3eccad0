"""Seconds a prove request spends solving and folding
(`backend/witness.py` `solve_and_batch`, `backend/ivc.py`,
`backend/nova.py`): the port's `--metrics` timer `Solver fa_solver+wit`."""


def read(run):
    return run.stage_mean("prove", "Solver", "fa_solver+wit")
