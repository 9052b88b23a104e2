"""Seconds from the start of the run's process to the start of its window."""


def read(run):
    return run["record"]["setup_s"]
