"""Whether what the window produced is right, judged by the plain
reference once the window has closed.

Four numbers, each an exact comparison (limit 0):

- `commitments_off`: commitments the window made (and, for a mix with
  one document, the set-up's) that differ from the reference's Hyrax
  commitment of the benchmark's document and the request's seed;
- `verdicts_off`: verify requests whose verdict differs from whether
  the document matches the regex (`re`), negated under `-n`;
- `proofs_off`: proofs whose claim about the document is not the
  document's, or not the circuit's (every proof), or whose opening
  against the commitment's rows fails (a sample of `OPENED_PROOFS`
  drawn from the seed), by `reference/proof.py`; under `-y` the claim
  about the document is the opening's last value, and every proof's
  split of v is checked too;
- `failed_requests`: requests that raised, or verifies that gave no
  verdict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from reference import artifact, commitment, proof, verdict

OPENED_PROOFS = 3
LIMITS = {"commitments_off": 0, "verdicts_off": 0, "proofs_off": 0,
          "failed_requests": 0}
ALPHABETS = {"dna": b"ACGT", "ascii": bytes(range(128))}
JUDGE_TAG = 6


def judge_run(config: dict, traffic, done: List[dict], seed: int
              ) -> Dict[str, Tuple[int, int]]:
    """{number: (value, limit)} over the requests in `done` (each a dict
    with the cycle, role, ok, verdict and artifacts)."""
    alphabet = list(ALPHABETS[config["alphabet"]])
    flags = list(config["flags"])
    negate = "-n" in flags
    off = 0
    for r in done:
        if r["role"] == "commit" and r["ok"]:
            cyc = r["cycle"]
            try:
                bad = commitment.mismatches(
                    artifact.loads(r["cmt"], "cmt"), alphabet,
                    traffic.document(cyc.doc_key), cyc.commit_seed, seed)
            except (ValueError, AttributeError, TypeError):
                bad = ["unreadable"]
            off += bool(bad)
    verdicts = 0
    for r in done:
        if r["role"] == "verify" and r["verdict"] is not None:
            cyc = r["cycle"]
            want = verdict.matches(cyc.regex,
                                   traffic.document(cyc.doc_key)) != negate
            verdicts += r["verdict"] != want
    proved = [r for r in done if r["role"] == "prove" and r["ok"]]
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & ((1 << 64) - 1), JUDGE_TAG]))
    opened = set(rng.choice(len(proved), min(OPENED_PROOFS, len(proved)),
                            replace=False).tolist()) if proved else set()
    proofs = 0
    for i, r in enumerate(proved):
        doc = traffic.document(r["cycle"].doc_key)
        try:
            bad = proof.mismatches(
                artifact.loads(r["cmt"], "cmt"),
                artifact.loads(r["proof"], "proof"),
                commitment.udoc(alphabet, doc), flags, i in opened)
        except (ValueError, AttributeError, TypeError):
            bad = ["unreadable"]
        proofs += bool(bad)
    values = {"commitments_off": off, "verdicts_off": verdicts,
              "proofs_off": proofs,
              "failed_requests": sum(not r["ok"] for r in done)}
    return {k: (v, LIMITS[k]) for k, v in values.items()}


def is_correct(checks: Dict[str, Tuple[int, int]]) -> bool:
    return all(v <= limit for v, limit in checks.values())
