"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have; a sound run comes out correct.
The harness's look for a card is skipped (the CPU runs the port's plain
kernels) and the cells' widths are cut to what a CPU test holds; the
limits are the cells' own."""

import numpy as np

from benchmark import run

BIG = 2**31 + 777


def test_sound_serve_run_is_correct(serve_cell):
    assert run.execute(serve_cell, BIG, 5.0, False, "cpu")["correct"]


def test_altered_answer_is_caught(serve_cell, monkeypatch):
    from snuffy_tpu_torch.pipeline import slide_inference

    real = slide_inference.predict_tiles

    def altered(*args, **kw):
        pred = real(*args, **kw)
        pred.instance_scores = pred.instance_scores.copy()
        pred.instance_scores[len(pred.instance_scores) // 2] += 0.25
        return pred

    monkeypatch.setattr(slide_inference, "predict_tiles", altered)
    res = run.execute(serve_cell, BIG, 5.0, False, "cpu")
    assert not res["correct"]


def test_altered_bag_score_is_caught(serve_cell, monkeypatch):
    from snuffy_tpu_torch.pipeline import slide_inference

    real = slide_inference.classify_bag

    def altered(*args, **kw):
        ins, bag = real(*args, **kw)
        return ins, float(np.clip(bag + 0.1, 0, 1) if bag < 0.9 else bag - 0.1)

    monkeypatch.setattr(slide_inference, "classify_bag", altered)
    res = run.execute(serve_cell, BIG, 5.0, False, "cpu")
    assert not res["correct"]

