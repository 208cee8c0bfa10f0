"""Stream time of the upload a tile: Σ upload_stream_s / Σ tiles of
`predict_tiles`' own timings (the stream's seconds between the CUDA
events at the edges of its `serve.upload` spans, recorded only under a
profiler), over the traced requests that carry it, in µs."""


def read(job):
    done = [p.timings for i, _, p in job.done
            if i in job.traced and "upload_stream_s" in p.timings]
    tiles = sum(t["n_patches"] for t in done)
    if not tiles:
        return None
    return 1e6 * sum(t["upload_stream_s"] for t in done) / tiles
