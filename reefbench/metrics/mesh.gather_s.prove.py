"""Seconds a prove request spends gathering the shards' partial results
on the process mesh's lead card (`reef_tpu_torch/parallel/mesh.py`): the
port's span `Mesh gather`, around the copies to the lead and their sum
there; for the sharded MSMs and the mesh IPA engine's rounds it ends when
the lead has the sum, so it holds the wait for the slowest card.  Spans
in helper threads add up across threads.  A port without the span, or a
run on one card, reads nothing."""


def read(run):
    return run.stage_mean("prove", "Mesh", "gather")
