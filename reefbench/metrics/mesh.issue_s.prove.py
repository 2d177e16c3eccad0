"""Seconds a prove request's host spends issuing the shards' launches on
the process mesh (`reef_tpu_torch/parallel/mesh.py`): the port's span
`Mesh issue`, around each sharded call's loop over its shards (the
sharded commit MSMs, each round of the sharded sumcheck, each round of
the compressed SNARK's mesh IPA engine), one Python thread issuing every
card's work.  Spans in helper threads add up across threads.  A port
without the span, or a run on one card, reads nothing."""


def read(run):
    return run.stage_mean("prove", "Mesh", "issue")
