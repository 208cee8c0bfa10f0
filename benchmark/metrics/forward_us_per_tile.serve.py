"""Stream time of the embedder's forward a tile: Σ forward_stream_s /
Σ tiles of `predict_tiles`' own timings (the compute stream's seconds
between the CUDA events at the edges of its `serve.forward` spans, one a
batch around the embedder's call, recorded only under a profiler), over
the traced requests that carry it, in µs."""


def read(job):
    done = [p.timings for i, _, p in job.done
            if i in job.traced and "forward_stream_s" in p.timings]
    tiles = sum(t["n_patches"] for t in done)
    if not tiles:
        return None
    return 1e6 * sum(t["forward_stream_s"] for t in done) / tiles
