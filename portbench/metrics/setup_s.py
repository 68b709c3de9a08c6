"""Seconds from the process's start to the first measured loop."""


def compute(record):
    return record["setup_s"]
