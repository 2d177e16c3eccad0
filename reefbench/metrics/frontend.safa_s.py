"""Seconds a prove request spends building the automaton from the regex
(`cli.build_safa`, frontend/safa.py): the port's `--metrics` timer
`Compiler regex_normalization+fa_builder`."""


def read(run):
    return run.stage_mean("prove", "Compiler",
                          "regex_normalization+fa_builder")
