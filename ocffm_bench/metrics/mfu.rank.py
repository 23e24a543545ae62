"""A request's required work at the card's published peaks (``work.py``:
the users' projections, every item's score, the top ids; the item side
read once) over the mean time a request of the traced window was served."""


def read(run):
    svc = run.get("service_s")
    if "bound_s" not in run or not svc:
        return None
    return 100.0 * run["bound_s"] / (sum(svc) / len(svc))
