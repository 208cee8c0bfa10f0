"""Upload time a tile: Σ upload_s / Σ tiles of `predict_tiles`' own
timings (the host's seconds in its `serve.upload` spans, each batch's
copy of the pageable tiles to the card), over the window's untraced
requests that carry it, in µs."""


def read(job):
    done = [p.timings for _, _, p in job.untraced()
            if "upload_s" in p.timings]
    tiles = sum(t["n_patches"] for t in done)
    if not tiles:
        return None
    return 1e6 * sum(t["upload_s"] for t in done) / tiles
