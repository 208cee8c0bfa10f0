"""Aggregator time a request: the mean `classify_s` of `predict_tiles`'
own timings (MILNet, selection, scores to the host), over the window's
untraced requests, in ms."""


def read(job):
    done = job.untraced()
    if not done:
        return None
    return 1e3 * sum(p.timings["classify_s"] for _, _, p in done) / len(done)
