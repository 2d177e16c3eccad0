"""Seconds a prove request spends in `backend/ipa.py` `ipa_prove`, on
either round engine: the port's span `Prover ipa`, around every IPA (the
compressed SNARK's two Spartan openings, and the consistency proof's
Hyrax opening and its CAP's two).  Spans in helper threads add up across
threads, so the IPAs together can read more than `prover.snark_s`'s wall
time.  A port without the span reads nothing."""


def read(run):
    return run.stage_mean("prove", "Prover", "ipa")
