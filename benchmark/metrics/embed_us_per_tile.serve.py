"""Embedder time a tile: Σ embed_s / Σ tiles of `predict_tiles`' own
timings (upload and embedding, synchronised), over the window's untraced
requests, in µs."""


def read(job):
    done = job.untraced()
    tiles = sum(p.timings["n_patches"] for _, _, p in done)
    if not tiles:
        return None
    return 1e6 * sum(p.timings["embed_s"] for _, _, p in done) / tiles
