"""The MILNet forward's dispatch a request: the mean milnet_s of
`predict_tiles`' own timings (the host's seconds in its `serve.milnet`
span, up to fetching the scores), over the window's untraced requests
that carry it, in ms."""


def read(job):
    done = [p.timings["milnet_s"] for _, _, p in job.untraced()
            if "milnet_s" in p.timings]
    if not done:
        return None
    return 1e3 * sum(done) / len(done)
