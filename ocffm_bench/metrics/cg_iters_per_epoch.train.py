"""CG iterations of an epoch (the sum of ``epoch_stats``'s per-solve
counts), averaged over the window's epochs."""


def read(run):
    iters = run.get("cg_iters")
    if not iters:
        return None
    return sum(sum(it) for it in iters) / len(iters)
