"""The traced job's required work at the card's published peaks (the
restore and every epoch, each pass the larger of its operations and its
bytes; ``work.py``) over the job's wall time."""


def read(run):
    if "bound_s" not in run or run["traced_wall_s"] <= 0:
        return None
    return 100.0 * run["bound_s"] / run["traced_wall_s"]
