"""Typed errors for clean rejection of malformed untrusted inputs.

The reference panics on malformed artifacts (expect/assert throughout
main.rs / framework.rs); here the verifier rejects cleanly: any layer that
parses attacker-supplied bytes (point decompression, artifact decoding,
proof structure) raises VerifyError, and run_verifier / the CLI catch it
and report an invalid proof instead of crashing.
"""


class VerifyError(ValueError):
    """Malformed or non-canonical prover-supplied data."""


class DecodeError(VerifyError):
    """Artifact bytes fail structural/schema validation."""
