"""Seconds a prove request spends in the public setup
(`backend/framework.py` `pub_setup`: table, R1CS, step circuit, keys):
the port's `--metrics` timer `Compiler r1cs_init`."""


def read(run):
    return run.stage_mean("prove", "Compiler", "r1cs_init")
