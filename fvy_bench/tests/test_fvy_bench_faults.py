"""The check sees each fault a cell can have: a run with the timed path
broken underneath (on the CPU at a tiny size, the look for a card
skipped) comes out with `correct` false."""

import pytest

from fvy_bench import run
from fvy_bench.tests.test_fvy_bench_rehearsal import TINY_TRAIN, tiny  # noqa: F401


def _stream_fault(monkeypatch, alter):
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline

    served = FaceDetectorPipeline.detect_batch_fused

    def broken(self, staged, geoms, **kw):
        cands, counts, *staged_dev = served(self, staged, geoms, **kw)
        return (*alter(cands.copy(), counts.copy()), *staged_dev)

    monkeypatch.setattr(FaceDetectorPipeline, "detect_batch_fused", broken)


def _half_left_out(cands, counts):
    counts[: len(counts) // 2] = 0
    return cands, counts


def _answers_altered(cands, counts):
    cands[..., [0, 2]] += 8.0  # every box moved 8 net pixels where it is produced
    return cands, counts


@pytest.mark.parametrize("workload",
                         ["fd_int8_stream_b40", "fi_int8_identify_b40", "fd_bf16_stream_b40"])
@pytest.mark.parametrize("alter", [_half_left_out, _answers_altered])
def test_detect_fault_fails_the_check(monkeypatch, tiny, workload, alter):
    _stream_fault(monkeypatch, alter)
    res = run.execute(workload, 77, 0.3, False, "cpu", tiny(workload))
    assert not res["correct"], res["checks"]


def _ids_half_left_out(rows):
    return [r if j % 2 else [] for j, r in enumerate(rows)]


def _ids_altered(rows):
    return [[dict(x, subject_id=(x["subject_id"] + 1) % 12) for x in r] for r in rows]


@pytest.mark.parametrize("alter", [_ids_half_left_out, _ids_altered])
def test_identify_fault_fails_the_check(monkeypatch, tiny, alter):
    from face_vijnana_yolov3_tpu_torch.api.face_identification import FaceIdentifierPipeline

    served = FaceIdentifierPipeline._identify_chunk_device

    def broken(self, *a, **kw):
        return alter(served(self, *a, **kw))

    monkeypatch.setattr(FaceIdentifierPipeline, "_identify_chunk_device", broken)
    res = run.execute("fi_int8_identify_b40", 79, 0.3, False, "cpu",
                      tiny("fi_int8_identify_b40"))
    assert not res["correct"], res["checks"]


def _unchanged(orig):
    def make(model, opt, **kw):
        step = orig(model, opt, **kw)

        def unchanged(params, state, opt_state, images, gts, weights):
            _p, _s, new_opt, loss = step(params, state, opt_state, images, gts, weights)
            return {k: v.detach().clone() for k, v in params.items()}, state, new_opt, loss

        return unchanged
    return make


def _half_batch(orig):
    def make(model, opt, **kw):
        step = orig(model, opt, **kw)

        def half(params, state, opt_state, images, gts, weights):
            h = images.shape[0] // 2
            return step(params, state, opt_state, images[:h], gts[:h], weights[:h])

        return half
    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_train_fault_fails_the_check(monkeypatch, fault):
    from face_vijnana_yolov3_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "make_train_step", fault(trainer.make_train_step))
    res = run.execute("fd_train_f32_b40", 78, 0.3, False, "cpu", TINY_TRAIN)
    assert not res["correct"], res["checks"]
