"""Share of the requests' device time that ran inside the span around
predict's ``rank_topk``."""


def read(run):
    d = run.get("digest")
    if not d:
        return None
    spans = d["span_device_s"]
    total, sort = spans.get("request", 0.0), spans.get("rank_topk", 0.0)
    if total <= 0 or sort <= 0:
        return None
    return 100.0 * sort / total
