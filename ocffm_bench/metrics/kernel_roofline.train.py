"""The traced job's required work at the card's published peaks
(``work.py``) over the time in which an operation ran on the card."""


def read(run):
    d = run.get("digest")
    if "bound_s" not in run or not d or d["busy_s"] <= 0:
        return None
    return 100.0 * run["bound_s"] / d["busy_s"]
