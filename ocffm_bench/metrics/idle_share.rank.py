"""Share of the requests' own time in which no operation ran on the card:
the device's idle time inside the ``request`` spans over their length.
The open loop's waits for the next due time lie outside those spans, so
the offered rate does not enter."""


def read(run):
    d = run.get("digest")
    if not d:
        return None
    wall = d.get("span_wall_s", {}).get("request", 0.0)
    if wall <= 0:
        return None
    return 100.0 * d["span_idle_s"]["request"] / wall
