"""Share of the traced job's window in which no operation ran on the card
(1 - the union of the device operations' intervals over the window)."""


def read(run):
    d = run.get("digest")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
