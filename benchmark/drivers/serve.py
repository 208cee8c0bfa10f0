"""Slide serving through `pipeline/slide_inference.predict_tiles`: one
client in a closed loop, each request one slide's tiles.

Traffic parameters (a `traffic/*.json` with `"driver": "serve"`):
  tiles_min, tiles_max  the log-uniform range of a slide's tile count
  sizes_per_cycle       K: each cycle sends the K quantiles of that range,
                        (i + ½)/K, in an order drawn from the seed, so
                        every seed sends the same work
  pool_tiles            the pool of distinct seeded tiles (uint8, pageable
                        host memory, as a decoder leaves them); a request
                        is a slice of it at an offset drawn from the seed
  tile_size             pixels a side
  embed_batch           `predict_tiles`' embed_batch
  trace_tiles           the traced stretch of a `--trace 1` run: whole
                        requests from the window's start until this many
                        tiles
  check_requests        the requests the reference checks after the window:
                        the first cycle's longest, others of that cycle
                        drawn from the seed, and the request at a position
                        drawn from the seed in the last cycle the window
                        completed
  assumed               where the mix's numbers come from

A request's latency runs from the call of `predict_tiles` until it
returns its scores on the host. Its MILNet seed (the random share's
generator) is drawn from the run's seed.

The check compares each checked request's instance scores whole, from the
benchmark's tiles to the scores on the host, with the reference's from the
same tiles and weights (`instance_logit_rms`: the RMS over the slide's
tiles of the logits' gap; no selection lies on that path). Not the widest
gap of the scores: the sigmoid's slope at the seed's logits and the one
tile that reads highest made that swing 3× from seed to seed, so bf16's
worst seed read a third of fp8's best. It also follows the program stage by stage from its own state, kept
for the checked requests during the window (`_capture`): the embedder from
the benchmark's tiles, the instance head from the program's embeddings,
the MILNet's encoder from the program's padded bag, the pooling and bag
head from the program's encoder output. The bag score is not compared
whole: the top-Λ selection is discontinuous, so from its own embeddings
the reference picks other rows at the boundary, and a bag score is one
projection per seed of an error that the seed's weights make large or
small, so its gap moved by as much in bf16 as in fp8. The embeddings and
the encoder's rows are compared whole, relative to their norm, where
rounding shows at every seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import arch, flops, program, roofline, weights
from benchmark.reference import common as ref_common
from benchmark.reference import milnet as ref_milnet

MAX_CYCLES = 256


def request_plan(traffic: dict, seed: int):
    """[(tiles, pool offset, MILNet seed)] in the order they are sent."""
    lo, hi, k = (traffic["tiles_min"], traffic["tiles_max"],
                 traffic["sizes_per_cycle"])
    sizes = [int(round(lo * (hi / lo) ** ((i + 0.5) / k))) for i in range(k)]
    rng = np.random.default_rng(weights.sub_seed(seed, "requests"))
    plan = []
    for _ in range(MAX_CYCLES):
        for i in rng.permutation(k):
            n = sizes[i]
            start = int(rng.integers(0, traffic["pool_tiles"] - n + 1))
            plan.append((n, start, int(rng.integers(0, 2**31 - 1))))
    return plan


def logit_rms(scores, z_ref) -> float:
    """The RMS over a slide's tiles of the gap between the instance logits
    behind float32 scores (σ⁻¹, in float64) and the reference's."""
    p = scores.astype(np.float64)
    return float(np.sqrt(np.mean((np.log(p) - np.log1p(-p) - z_ref) ** 2)))


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.trace = None
        self.kernel_bound_s = {}
        self.compute_dtype = config["embedder"]["compute_dtype"]

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from snuffy_tpu_torch.pipeline.slide_inference import (
            classify_bag,
            embed_bag,
        )
        from snuffy_tpu_torch.data.bucketing import bucket_length

        t, dev = self.traffic, self.device
        self.embedder = program.build_embedder(
            self.config, program.embedder_weights(self.config, self.seed, dev),
            dev)
        self.milnet = program.build_milnet(
            self.config, program.milnet_weights(self.config, self.seed, dev),
            dev)
        gen = torch.Generator(dev).manual_seed(
            weights.sub_seed(self.seed, "tiles"))
        side, total = t["tile_size"], t["pool_tiles"]
        # one pageable host allocation, filled from the device in chunks
        self.pool = torch.empty((total, side, side, 3), dtype=torch.uint8)
        for start in range(0, total, 1000):
            n = min(1000, total - start)
            self.pool[start:start + n].copy_(torch.randint(
                0, 256, (n, side, side, 3), generator=gen, device=dev,
                dtype=torch.uint8))
        self.plan = request_plan(t, self.seed)
        # every shape the traffic uses: the full batch, each slide's tail
        # batch, each slide's bucket
        eb = t["embed_batch"]
        sizes = sorted({n for n, _, _ in self.plan[:t["sizes_per_cycle"]]})
        for b in sorted({eb} | {n % eb for n in sizes if n % eb}):
            embed_bag(self.pool[:b], self.embedder, dev, embed_batch=eb,
                      embed_size=self.config["embedder"]["img_size"])
        d = self.config["milnet"]["feats_size"]
        for n_pad in sorted({bucket_length(n) for n in sizes}):
            classify_bag(torch.zeros((n_pad, d), device=dev), n_pad - 1,
                         self.milnet, 0)
        self._serve(self.plan[0])
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve(self, req):
        from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

        n, start, rseed = req
        return predict_tiles(
            self.pool[start:start + n], self.embedder, self.milnet,
            embed_batch=self.traffic["embed_batch"],
            embed_size=self.config["embedder"]["img_size"], seed=rseed)

    # ------------------------------------------------------------- window
    def window(self, seconds: float, tracer=None) -> None:
        restore = self._capture()
        try:
            self._loop(seconds, tracer)
        finally:
            restore()
        missing = set(self.sample()) - (set(self.bags) & set(self.encs))
        if missing:
            raise RuntimeError(f"the window ended before the checked "
                               f"requests {sorted(missing)} finished: give "
                               f"it a cycle of the mix or more")
        if self.trace is not None:
            self._kernel_bounds()

    def _loop(self, seconds: float, tracer) -> None:
        """The closed loop: one request after another until `seconds`
        have passed; with a tracer, whole requests from the start until
        `trace_tiles` tiles are traced (once more where the first trace
        holds no device time)."""
        self.done = []        # (request index, latency s, prediction)
        traced_tiles, tries = 0, 0
        tracing = tracer is not None
        if tracing:
            tracer.start()
        self.traced = set()
        self.untraced_start = None
        t0 = time.perf_counter()
        for i, req in enumerate(self.plan):
            if tracing and traced_tiles >= self.traffic["trace_tiles"]:
                self.trace = tracer.stop()
                tries += 1
                if self.trace is None and tries < 2:
                    tracer.start()
                    traced_tiles = 0
                else:
                    tracing = False
            if not tracing and self.untraced_start is None:
                self.untraced_start = time.perf_counter()
            self.current = i
            a = time.perf_counter()
            pred = self._serve(req)
            self.done.append((i, time.perf_counter() - a, pred))
            if tracing:
                self.traced.add(i)
                traced_tiles += req[0]
            if time.perf_counter() - t0 >= seconds:
                break
        if tracing:
            self.trace = tracer.stop()
        self.window_s = time.perf_counter() - t0
        self.window_end = time.perf_counter()

    def _kernel_bounds(self) -> None:
        e, m = self.config["embedder"], self.config["milnet"]
        eb, out = self.traffic["embed_batch"], {}
        heads, dk = m["num_heads"], m["feats_size"] // m["num_heads"]
        for i in self.traced:
            n = self.plan[i][0]
            slots = roofline.live_slots(n, ref_milnet.k_top(m),
                                        ref_milnet.k_rand(m))
            out["sparse_attention_fwd"] = out.get(
                "sparse_attention_fwd", 0.0) + m["depth"] * (
                roofline.sparse_fwd_bound(heads, dk, n, slots,
                                          m["compute_dtype"]))
            batches = [eb] * (n // eb) + ([n % eb] if n % eb else [])
            for kernel, s in arch.load(e).kernel_bounds(e, batches).items():
                out[kernel] = out.get(kernel, 0.0) + s
        self.kernel_bound_s = out

    def results(self) -> dict:
        lat = [s for _, s, _ in self.done]
        tiles = sum(self.plan[i][0] for i, _, _ in self.done)
        return {"slide_p90_s": float(np.percentile(lat, 90)),
                "tiles_per_s": tiles / self.window_s}

    def counts(self):
        failed = sum(1 for _, _, p in self.done
                     if not (np.isfinite(p.bag_score)
                             and np.isfinite(p.instance_scores).all()))
        return len(self.done), failed

    def untraced(self):
        return [(i, s, p) for i, s, p in self.done if i not in self.traced]

    def untraced_work(self):
        """(FLOPs, seconds) of the window's requests outside the trace."""
        if self.untraced_start is None:
            return 0, 0.0
        done = sum(self.request_flops(self.plan[i][0])
                   for i, _, _ in self.untraced())
        return done, self.window_end - self.untraced_start

    def request_flops(self, n: int) -> int:
        m = self.config["milnet"]
        slots = roofline.live_slots(n, ref_milnet.k_top(m),
                                    ref_milnet.k_rand(m))
        return (n * flops.embedder_flops_per_tile(self.config["embedder"])
                + flops.milnet_forward_flops(n, slots, m["feats_size"],
                                             m["depth"], m["num_classes"],
                                             m["mlp_multiplier"]))

    # -------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's models; the checked requests' bags stay."""
        del self.embedder, self.milnet
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _picks(self):
        """(requests of the first cycle to check, the position in a cycle
        of the one checked in the last cycle the window completes)."""
        k = self.traffic["sizes_per_cycle"]
        longest = max(range(k), key=lambda i: self.plan[i][0])
        rest = [i for i in range(k) if i != longest]
        rng = np.random.default_rng(weights.sub_seed(self.seed, "check"))
        picks = rng.choice(rest, self.traffic["check_requests"] - 2,
                           replace=False)
        return ([longest] + sorted(int(i) for i in picks),
                int(rng.integers(0, k)))

    def sample(self) -> list:
        """The plan's requests that the reference checks: the longest of
        the first cycle (the mix's longest), others of that cycle drawn
        from the seed, and the one at a position drawn from the seed in
        the last cycle the window completed. A window of a cycle or more
        finishes them all."""
        first, at = self._picks()
        k = self.traffic["sizes_per_cycle"]
        cycles = len(getattr(self, "done", ())) // k
        last = (max(cycles, 1) - 1) * k + at
        return sorted(set(first) | {last})

    def _capture(self):
        """Keep, for each request that may be checked, what the timed path
        made: the padded bag of the port's `embed_bag` (wrapped:
        `predict_tiles` calls it by name) and the output of the MILNet's
        encoder (a forward hook). Each checked stage starts from them. Of
        the requests at the last cycle's drawn position, the newest two
        are kept: the last whole cycle's is one of them."""
        from snuffy_tpu_torch.pipeline import slide_inference

        real, job = slide_inference.embed_bag, self
        first, at = self._picks()
        k = self.traffic["sizes_per_cycle"]
        self.bags, self.encs = {}, {}

        def keep(store, value):
            i = job.current
            if i in store or not (i in first or i % k == at):
                return
            store[i] = value
            for old in [j for j in store if j not in first and j < i - k]:
                del store[old]

        def embed_bag(*args, **kw):
            bag = real(*args, **kw)
            keep(job.bags, bag)
            return bag

        def hook(module, inputs, output):
            keep(job.encs, output)

        slide_inference.embed_bag = embed_bag
        handle = self.milnet.b_classifier.encoder.register_forward_hook(hook)

        def restore():
            slide_inference.embed_bag = real
            handle.remove()

        return restore

    def reference_feats(self, req, q=ref_common.identity) -> torch.Tensor:
        """The reference's embeddings (n, d) of the request's tiles, every
        product's operands read through `q`."""
        n, start, _ = req
        e, dev = self.config["embedder"], self.device
        ref = program.embedder_reference(e)
        w_e = program.embedder_weights(self.config, self.seed, dev)
        eb, out = self.traffic["embed_batch"], []
        with torch.no_grad(), ref_common.exact_float32():
            for a in range(0, n, eb):
                tiles = self.pool[start + a:start + min(n, a + eb)].to(dev)
                out.append(ref.embed(w_e, tiles, e, q))
        return torch.cat(out)

    def reference_logits(self, feats, q=ref_common.identity):
        """Instance logits of embeddings (n, d) by the reference's head."""
        w_m = program.milnet_weights(self.config, self.seed, self.device)
        with torch.no_grad(), ref_common.exact_float32():
            return ref_common.dense(
                feats.float(), w_m["i_classifier.fc.0.weight"],
                w_m["i_classifier.fc.0.bias"], q)[:, 0].cpu()

    def reference_instances(self, feats, q=ref_common.identity):
        """Instance scores of embeddings (n, d) by the reference's head."""
        return torch.sigmoid(self.reference_logits(feats, q)).numpy()

    def reference_encoder(self, req, bag, q=ref_common.identity):
        """The reference MILNet's encoder output (n, d) for the padded bag
        (n_pad, d), the random share drawn from the request's seed."""
        n, _, rseed = req
        m, dev = self.config["milnet"], self.device
        w_m = program.milnet_weights(self.config, self.seed, dev)
        with torch.no_grad(), ref_common.exact_float32():
            mask = torch.arange(bag.shape[0], device=dev) < n
            gen = torch.Generator(dev).manual_seed(rseed)
            _, _, enc = ref_milnet.forward(w_m, bag.float(), mask, m, 1, gen,
                                           q=q)
        return enc[:n]

    def reference_bag(self, enc, q=ref_common.identity) -> float:
        """The bag score of the encoder's valid rows (n, d): their mean
        through the reference's bag head."""
        w_m = program.milnet_weights(self.config, self.seed, self.device)
        with torch.no_grad(), ref_common.exact_float32():
            logit = ref_common.dense(enc.float().mean(dim=0),
                                     w_m["b_classifier.linear.weight"],
                                     w_m["b_classifier.linear.bias"], q)
        return float(torch.sigmoid(logit[0]))

    def compare(self, control=False) -> list:
        """Per sampled request: ins_e2e (the RMS gap of its instance logits,
        from its scores, against the reference's from the same tiles), then
        each stage from the
        program's own state: embed_rel (the program's embeddings against
        the reference's of the same tiles, relative Frobenius), ins_gap
        (its instance scores against the reference head on its
        embeddings), enc_rel (its encoder output against the reference
        encoder on its bag) and bag_gap (its bag score against the
        reference pooling and head on its encoder output). With `control`,
        each again with the reference in the next precision below the
        stage's put in the program's place: fp8 for the bf16 stages, TF32
        for the float32 heads."""
        def rel(a, b):
            return float((a.float() - b).norm() / b.norm())

        preds = {i: p for i, _, p in self.done}
        low = ref_common.CONTROLS[self.compute_dtype]
        low32 = ref_common.CONTROLS["float32"]
        out = []
        for i in self.sample():
            req, pred = self.plan[i], preds[i]
            n = req[0]
            feats, enc = self.bags[i][:n], self.encs[i][:n]
            f_ref = self.reference_feats(req)
            e_ref = self.reference_encoder(req, self.bags[i])
            z_ref = self.reference_logits(f_ref).double().numpy()
            ins_ref = self.reference_instances(feats)
            bag_ref = self.reference_bag(enc)
            row = {"request": i, "tiles": n,
                   "ins_e2e": logit_rms(pred.instance_scores, z_ref),
                   "embed_rel": rel(feats, f_ref),
                   "ins_gap": float(np.abs(pred.instance_scores
                                           - ins_ref).max()),
                   "enc_rel": rel(enc, e_ref),
                   "bag_gap": abs(pred.bag_score - bag_ref)}
            if control:
                f_low = self.reference_feats(req, low)
                row["control"] = {
                    "ins_e2e": logit_rms(self.reference_instances(
                        f_low, low32), z_ref),
                    "embed_rel": rel(f_low, f_ref),
                    "ins_gap": float(np.abs(self.reference_instances(
                        feats, low32) - ins_ref).max()),
                    "enc_rel": rel(self.reference_encoder(
                        req, self.bags[i], low), e_ref),
                    "bag_gap": abs(self.reference_bag(enc, low32) - bag_ref)}
            out.append(row)
        return out

    @staticmethod
    def numbers(rows) -> dict:
        """Each stage's worst request."""
        return {"instance_logit_rms": max(r["ins_e2e"] for r in rows),
                "embed_rel_err": max(r["embed_rel"] for r in rows),
                "instance_score_gap": max(r["ins_gap"] for r in rows),
                "encoder_rel_err": max(r["enc_rel"] for r in rows),
                "bag_score_gap": max(r["bag_gap"] for r in rows)}

    def check(self) -> dict:
        return self.numbers(self.compare())

    def control(self) -> dict:
        """The numbers `check` compares, read with the controls in the
        program's place, and the rows they come from."""
        rows = self.compare(control=True)
        return {"lower_precision": self.numbers(
                    [r["control"] for r in rows]),
                "program": self.numbers(rows), "rows": rows}
